"""Graph ops and the two kernels of the packing path (``message``,
``chain``), each with its plain PyTorch version."""
