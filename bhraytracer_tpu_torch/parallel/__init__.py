"""Inverse rendering on one device (sharding.py); the multi-device mesh
is not ported yet."""
