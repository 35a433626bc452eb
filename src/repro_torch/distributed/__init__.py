"""Distribution over ranks: the placement rules (``sharding``), the rank
pool (``ranks``: one process a rank over gloo groups), the collectives a
rank's body calls (``collectives``), int8 compressed data-parallel
gradients (``compression``) and the GPipe schedule (``pipeline``)."""
