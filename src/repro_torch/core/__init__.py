"""Escoin core, PyTorch port: sparse formats, pruning, the non-kernel conv
methods (``dense``, ``csr-direct``, ``lowered``) and the plain sparse
linear products."""
from repro_torch.core.direct_conv import (dense_conv, direct_sparse_conv,
                                          gather_windows, out_spatial,
                                          pad_in, pixel_offsets,
                                          stretched_offsets)
from repro_torch.core.lowering import im2col, lowered_sparse_conv
from repro_torch.core.pruning import block_prune, magnitude_prune
from repro_torch.core.sparse_format import (
    BcsrConv, BcsrMatrix, EllConv, EllMatrix, balance_ell_conv,
    bcsr_conv_from_dense, bcsr_conv_to_dense, bcsr_from_dense,
    bcsr_stack_from_dense, bcsr_to_dense, ell_from_dense, ell_from_dense_conv,
    inverse_permutation)
from repro_torch.core.sparse_linear import bcsr_matmul, dense_matmul, ell_matmul
from repro_torch.core.types import DENSE, SparsityConfig, escoin

__all__ = [
    "BcsrConv", "BcsrMatrix", "DENSE", "EllConv", "EllMatrix",
    "SparsityConfig", "balance_ell_conv", "bcsr_conv_from_dense",
    "bcsr_conv_to_dense", "bcsr_from_dense", "bcsr_matmul",
    "bcsr_stack_from_dense", "bcsr_to_dense", "block_prune", "dense_conv",
    "dense_matmul", "escoin", "direct_sparse_conv", "gather_windows",
    "ell_from_dense", "ell_from_dense_conv", "ell_matmul", "im2col",
    "inverse_permutation", "lowered_sparse_conv", "magnitude_prune",
    "out_spatial", "pad_in", "pixel_offsets", "stretched_offsets",
]
