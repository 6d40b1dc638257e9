"""Executable nodes (reference: src/lcm_nodes): the farm perception node and the object mesher node."""
