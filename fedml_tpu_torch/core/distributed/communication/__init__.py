"""Transports: the in-process LOCAL broker, and the TCP pub/sub broker with
its object-store offload (BROKER)."""
