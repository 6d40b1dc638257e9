"""Image operations, solvers and the Hopper kernel launcher."""
