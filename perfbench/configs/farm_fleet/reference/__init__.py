"""The plain reference of the ``farm_fleet`` configuration: the farm node's
processing written anew from the algorithms it runs, in plain PyTorch, in
any precision, with nothing of the port or the JAX package imported.

- ``image``: the image operations (OpenCV's and ``jax.image.resize``'s);
- ``stereo``: PatchMatch disparity and depth;
- ``enhance``: the Sea-thru enhancement;
- ``tracker``: the stereo tracker's frame;
- ``mesher``: the foreground mask and the landmark graph.
"""
