"""Continuous-batching serving over an execution backend."""
