"""Batched IEEE 802.11a/n/ac PHY framework in JAX."""
