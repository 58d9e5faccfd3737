"""Forward flash attention: the CUDA kernel (``kernel``), its plain version
(``ref``) and the (B, S, H, D) layer the model calls (``ops``)."""
