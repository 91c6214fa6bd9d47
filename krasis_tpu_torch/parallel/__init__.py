"""Parallelism: the device mesh, parameter and cache placement, expert- and
head-sharded forwards, pipeline and sequence parallelism."""
