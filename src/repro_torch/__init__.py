"""PyTorch/CUDA port of the Hexa-MoE system (``repro`` is the JAX reference).

The first slice serves decoder LMs through the paged continuous-batching
engine (``launch.serve.PagedServer``), with hand-written CUDA kernels for
the fused expert FFN (``kernels.esffn``) and paged decode attention
(``kernels.paged_attention``). Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
