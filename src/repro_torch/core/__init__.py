"""The paper's contribution in PyTorch: linear-time self-attention by
Modified Spectral Shifting, plus the Nystromformer baseline and the SPSD
matrix approximations it improves on (``repro/core/__init__.py``)."""

from repro_torch.core.attention import (
    SSConfig,
    attention,
    chunked_attention,
    full_attention,
    nystrom_attention,
    spectral_shift_attention,
)
from repro_torch.core.landmarks import segment_means
from repro_torch.core.matrix_approx import (approximate_spsd, flat_tail_spsd,
                                            sample_columns)
from repro_torch.core.pinv import iterative_pinv, svd_pinv
from repro_torch.core.spectral_shift import SSCore, ss_core

__all__ = [
    "SSConfig",
    "SSCore",
    "attention",
    "approximate_spsd",
    "chunked_attention",
    "flat_tail_spsd",
    "full_attention",
    "iterative_pinv",
    "nystrom_attention",
    "sample_columns",
    "segment_means",
    "spectral_shift_attention",
    "ss_core",
    "svd_pinv",
]
