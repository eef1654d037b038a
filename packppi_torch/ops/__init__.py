"""Graph ops and the kernels of the packing and refinement paths
(``message``, ``chain``, ``clash``), each with its plain PyTorch version."""
