"""Grid generation, packing, evaluation and pair kernels of the port."""
