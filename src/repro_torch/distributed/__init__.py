"""Fault tolerance, meshes, sharding rules and uplink compressors of the
port."""
