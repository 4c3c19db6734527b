"""The harness's own code: meshes, inputs, byte counts, caches, the window and the trace."""
