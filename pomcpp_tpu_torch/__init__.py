"""PyTorch/CUDA port of the Pommerman engine in ``pomcpp_tpu``.

Plain PyTorch functions on int32 tensors with a leading batch axis, plus
hand-written CUDA kernels for Hopper (``csrc/``) behind the entry points in
``engine.fused_step``.  Entry points take ``device=None``, which means CUDA;
running on the CPU has to be asked for with ``device="cpu"``.
"""
