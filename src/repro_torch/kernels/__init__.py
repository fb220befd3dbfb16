"""Hand-written CUDA kernels for Hopper, one package each (``csrc/*.cu`` +
``kernel.py`` launcher + ``ref.py`` plain PyTorch version + ``ops.py``
wrapper), built by ``_build.py``; ``conv_ablate.py`` is what the two conv
kernels' ablation scripts share.

sparse_conv -- the paper's direct sparse convolution over an ELL bank
               (replaces the Pallas ``sparse_conv_pallas``)
bsr_conv    -- block-sparse (BCSR) direct convolution on the tensor cores
               (replaces the Pallas ``bsr_conv_pallas``)
bsr_matmul  -- block-sparse (BCSR) matmul y = x @ W.T for the transformer's
               projections (replaces the Pallas ``bsr_matmul_pallas``)
flash_attention -- causal / full GQA attention forward with online softmax
               (replaces the Pallas flash-attention ``_fwd_call``)
"""
