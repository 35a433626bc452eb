"""Tensor-parallel placement: which dimension of each parameter and cache
leaf splits over the ``model`` axis (``sharding``)."""
