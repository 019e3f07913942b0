"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of
the JAX package. Each ships its CUDA source under ``csrc/``, an
``ops.py`` wrapper (checks, dispatch, launch counts) and a ``ref.py``
plain PyTorch version.

* ``aggregate`` — masked/scaled client-gradient aggregation (paper
  eq. 11/12) and the fused reduce-and-update server step.
* ``flash_attention`` — blockwise causal/windowed GQA attention on the
  tensor cores, the LM prefill's attention.
* ``ssm_scan`` — the chunked gated-linear-recurrence scan (Mamba2 SSD /
  mLSTM), the state slice carried in shared memory along the sequence.
"""
