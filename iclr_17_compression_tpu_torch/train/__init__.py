"""Weights: the port's reader of flax msgpack files and the bridge from the
JAX parameter tree."""
