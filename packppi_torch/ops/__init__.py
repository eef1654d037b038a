"""Graph ops and the kernels of the packing, refinement and training paths
(``message``, ``message_feat``, ``chain``, ``clash``), each with its plain
PyTorch version."""
