"""Obstacle meshing: foreground mask, landmark graph, clusters, meshes."""
