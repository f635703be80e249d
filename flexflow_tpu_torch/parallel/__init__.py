"""Graph structures (the PCG); strategies and meshes come with the
multi-GPU slice."""
