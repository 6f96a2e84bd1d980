"""The port's kernels: CUDA C++ for Hopper (``csrc/``) behind wrappers that
launch them for CUDA tensors and run their plain PyTorch versions for CPU
tensors.

    K1  ss_attention.landmark_summary      (csrc/landmark_summary.cu)
    K2  ss_attention.query_side            (csrc/query_side.cu)
    K5  paged_decode.paged_row_stats_lanes (csrc/paged_row_stats.cu)
    K5' paged_decode.paged_row_stats       (K5 launched with one lane)
    K3  ss_attention_bwd.landmark_summary_bwd (csrc/landmark_summary_bwd.cu)
    K4  ss_attention_bwd.query_side_bwd       (csrc/query_side_bwd.cu)

``ops`` holds the fused attention built on them (``ss_attention_fused``,
``nystrom_attention_fused``), ``dispatch`` the plan registry with measured
autotune that picks a route and the kernels' tiling per shape.

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``); ``launch_counts`` reads them and
``reset_launch_counts`` zeroes them, so a run can show that its path went
through the kernels.

``HEAD_DIM_LIMITS`` holds each kernel's own largest (d, dv): the key /
query width and the value width it takes (each ``.cu`` file's ``kMaxD``
and ``kMaxDv``). K1, K2 and K5 take absorbed MLA's 576 / 512 (kv_lora 512
+ rope 64 keys, the 512-wide latents as values) through wide-head variants
they dispatch to by shape; the training kernels K3 and K4 stay at 128.
The serving engine refuses, on CUDA and at construction, head dims past
the limits of the kernels it will launch.
"""
from __future__ import annotations

HEAD_DIM_LIMITS = {
    "landmark_summary": (576, 512),
    "query_side": (576, 512),
    "paged_row_stats": (576, 512),
    "landmark_summary_bwd": (128, 128),
    "query_side_bwd": (128, 128),
}
SERVE_KERNELS = ("landmark_summary", "query_side", "paged_row_stats")


def kernels_past(d: int, dv: int, names) -> list[str]:
    """The kernels among ``names`` whose (d, dv) limit head dims (d, dv)
    exceed."""
    return [name for name in names
            if d > HEAD_DIM_LIMITS[name][0] or dv > HEAD_DIM_LIMITS[name][1]]


def check_head_dims(name: str, d: int, dv: int) -> None:
    """Raise ValueError unless kernel ``name`` takes head dims (d, dv)."""
    if kernels_past(d, dv, (name,)):
        max_d, max_dv = HEAD_DIM_LIMITS[name]
        raise ValueError(f"{name}: head dims (d={d}, dv={dv}) exceed the kernel's "
                         f"({max_d}, {max_dv})")


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


# Public entry points, as the reference's package exports them (imported
# last: the kernel modules import the limits above).
from repro_torch.kernels.dispatch import (  # noqa: E402
    Plan,
    PlanKey,
    autotune,
    autotune_decode,
    dispatch_ss_attention,
    get_plan,
    load_cache,
    make_key,
    register_plan,
    save_cache,
)
from repro_torch.kernels.ops import (  # noqa: E402
    flash_merge,
    flash_rescale,
    landmark_summary_op,
    nystrom_attention_fused,
    query_side_op,
    ss_attention_fused,
    ss_core_factors,
)
from repro_torch.kernels.paged_decode import (  # noqa: E402
    paged_row_stats,
    paged_row_stats_lanes,
)
from repro_torch.kernels.ss_attention import landmark_summary, query_side  # noqa: E402
from repro_torch.kernels.ss_attention_bwd import (  # noqa: E402
    landmark_summary_bwd,
    query_side_bwd,
)
