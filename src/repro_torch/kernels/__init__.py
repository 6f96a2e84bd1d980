"""The port's kernels: CUDA C++ for Hopper (``csrc/``) behind wrappers that
launch them for CUDA tensors and run their plain PyTorch versions for CPU
tensors.

    K1  ss_attention.landmark_summary      (csrc/landmark_summary.cu)
    K2  ss_attention.query_side            (csrc/query_side.cu)
    K5  paged_decode.paged_row_stats_lanes (csrc/paged_row_stats.cu)
    K3  ss_attention_bwd.landmark_summary_bwd (csrc/landmark_summary_bwd.cu)
    K4  ss_attention_bwd.query_side_bwd       (csrc/query_side_bwd.cu)

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``); ``launch_counts`` reads them and
``reset_launch_counts`` zeroes them, so a run can show that its path went
through the kernels.

``MAX_HEAD_DIM`` is the largest head dim (d and dv) that every kernel
takes (each ``.cu`` file's ``kMaxD``); the serving engine refuses larger
heads on CUDA at construction.
"""
from __future__ import annotations

MAX_HEAD_DIM = 128


def _wrappers():
    from repro_torch.kernels.paged_decode import paged_row_stats_lanes
    from repro_torch.kernels.ss_attention import landmark_summary, query_side
    from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,
                                                      query_side_bwd)

    return {"landmark_summary": landmark_summary, "query_side": query_side,
            "paged_row_stats": paged_row_stats_lanes,
            "landmark_summary_bwd": landmark_summary_bwd,
            "query_side_bwd": query_side_bwd}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
