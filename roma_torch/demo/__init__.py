"""The demos of the JAX package's ``demo/``, each run as ``python -m
roma_torch.demo.<name> --im_A_path A --im_B_path B [--device cpu]`` (the
images are required arguments; the device defaults to the GPU)."""
