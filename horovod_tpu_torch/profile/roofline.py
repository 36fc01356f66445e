"""Per-device peak tables and MFU/roofline math.

Port of the JAX package's ``profile/roofline.py``. MFU is achieved model
FLOP/s over the device's peak dense bf16 FLOP/s. Model FLOPs come from an
explicit ``hvd.set_flops_per_step()`` (the paper-formula route, e.g.
``6·N·B·L`` for transformer training) or from :func:`flops_of_step`, which
counts one step with ``torch.utils.flop_counter.FlopCounterMode`` — where
JAX reads XLA's cost analysis. The counter sees ATen operators only: the
port's hand-written flash-attention kernels are invisible to it on the
GPU, so a caller adds :func:`attention_flops` for them (on the CPU the
plain attention's products are ATen operators and are counted). Wire
utilization is collective bytes per second against the interconnect roof:
NVLink within a node, the NIC across nodes.

Peaks are spec-sheet figures; the CPU row is an order-of-magnitude
placeholder so the CPU tier still produces ratios (flagged ``estimate``).
Override any peak with ``HOROVOD_PEAK_TFLOPS`` / ``HOROVOD_PEAK_HBM_GBS`` /
``HOROVOD_PEAK_ICI_GBS`` / ``HOROVOD_PEAK_DCN_GBS`` (the ``ici`` roof is
the intra-node link, ``dcn`` the one across nodes, JAX's key names).
"""

# device -> peaks: dense bf16 TFLOP/s, HBM GB/s, intra-node link GB/s per
# device (one direction, keyed "ici_gbs" as in JAX), cross-node GB/s per
# node (keyed "dcn_gbs").
PEAKS = {
    # NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet): 989
    # TFLOP/s dense BF16 tensor-core, 3,350 GB/s HBM3, NVLink 4 at 900
    # GB/s bidirectional = 450 GB/s one direction; one 400 Gb/s
    # (50 GB/s) NIC per GPU across nodes.
    "h100": {"bf16_tflops": 989.0, "hbm_gbs": 3350.0, "ici_gbs": 450.0,
             "dcn_gbs": 50.0},
    # CPU tier (tests, dry runs): order-of-magnitude placeholder so MFU
    # ratios stay computable — never quote these as hardware truth.
    "cpu": {"bf16_tflops": 0.2, "hbm_gbs": 50.0, "ici_gbs": 10.0,
            "dcn_gbs": 10.0, "estimate": True},
}


def detect_chip():
    """Best-effort device from ``torch.cuda.get_device_name``: one of the
    PEAKS keys. Never raises (profiling must not fail the job)."""
    try:
        import torch
        if not torch.cuda.is_available():
            return "cpu"
        name = torch.cuda.get_device_name().lower()
        if "h100" in name:
            return "h100"
        return "cpu"
    except Exception:  # noqa: BLE001
        return "cpu"


def chip_peaks(chip=None):
    """Peak table for ``chip`` (default: detected), env overrides
    applied. Returns a fresh dict: ``bf16_tflops``, ``hbm_gbs``,
    ``ici_gbs``, ``dcn_gbs``, ``chip`` (+ ``estimate`` on the CPU row)."""
    chip = chip or detect_chip()
    peaks = dict(PEAKS.get(chip, PEAKS["cpu"]))
    peaks["chip"] = chip

    from horovod_tpu_torch.common.config import Config, _env_float

    def _ovr(env, field, key):
        v = _env_float(env, getattr(Config, field))
        if v > 0:    # Config's 0: the detected card's row
            peaks[key] = v

    _ovr("HOROVOD_PEAK_TFLOPS", "peak_tflops", "bf16_tflops")
    _ovr("HOROVOD_PEAK_HBM_GBS", "peak_hbm_gbs", "hbm_gbs")
    _ovr("HOROVOD_PEAK_ICI_GBS", "peak_ici_gbs", "ici_gbs")
    _ovr("HOROVOD_PEAK_DCN_GBS", "peak_dcn_gbs", "dcn_gbs")
    return peaks


def flops_of_step(fn, *args, **kwargs):
    """FLOPs of one call ``fn(*args, **kwargs)`` (a training step: forward,
    backward, optimizer) as ``FlopCounterMode`` counts its ATen operators.
    Returns ``(flops, result)``; flops is None when the counter fails.
    The port's flash-attention kernels on the GPU are not ATen operators:
    add :func:`attention_flops` for them."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        counter = FlopCounterMode(display=False)
    except TypeError:             # an older signature
        counter = FlopCounterMode()
    with counter:
        out = fn(*args, **kwargs)
    try:
        flops = float(counter.get_total_flops())
    except Exception:  # noqa: BLE001
        flops = None
    return (flops if flops else None), out


def attention_flops(batch_heads, q_len, kv_len, head_dim, causal=False,
                    training=True):
    """Model FLOPs of scaled-dot-product attention over ``batch_heads``
    heads: ``QKᵀ`` and ``PV`` at 2 FLOPs a multiply-add each, half the
    score matrix when causal (square); a training step adds the backward's
    ``dV``, ``dP``, ``dQ`` and ``dK`` products, twice the forward's."""
    fwd = 4.0 * batch_heads * q_len * kv_len * head_dim
    if causal and q_len == kv_len:
        fwd *= 0.5
    return fwd * (3.0 if training else 1.0)


def mfu(flops_per_step, step_seconds, peaks=None):
    """Model FLOP/s utilization: achieved TFLOP/s / peak bf16 TFLOP/s.
    Returns ``(mfu_fraction, achieved_tflops)`` or ``(None, None)``."""
    if not flops_per_step or not step_seconds or step_seconds <= 0:
        return None, None
    peaks = peaks or chip_peaks()
    achieved = flops_per_step / step_seconds / 1e12
    peak = peaks.get("bf16_tflops") or 0.0
    return (achieved / peak if peak > 0 else None), achieved


def tier_time_estimate(bytes_by_tier, world_size, num_slices=1, peaks=None):
    """Roofline LOWER-BOUND time for one step's per-link-tier byte totals
    (``{"ici": b, "dcn": b}``, JAX's tier names): the ``ici`` total is
    spread over the ``world_size`` devices against the per-device
    intra-node roof, the ``dcn`` total over the ``num_slices`` cross-node
    links against that roof. Returns ``{"ici_s", "dcn_s", "bound",
    "chip", "estimate"}`` — ``bound`` names the slower tier."""
    peaks = peaks or chip_peaks()
    world_size = max(int(world_size), 1)
    num_slices = max(int(num_slices), 1)
    ici = float(bytes_by_tier.get("ici", 0) or 0)
    dcn = float(bytes_by_tier.get("dcn", 0) or 0)
    ici_roof = (peaks.get("ici_gbs") or 0.0) * 1e9
    dcn_roof = (peaks.get("dcn_gbs") or 0.0) * 1e9
    t_ici = (ici / world_size / ici_roof) if ici_roof > 0 else None
    t_dcn = (dcn / num_slices / dcn_roof) if dcn_roof > 0 else None
    bound = "dcn" if (t_dcn or 0.0) >= (t_ici or 0.0) else "ici"
    return {"ici_s": t_ici, "dcn_s": t_dcn, "bound": bound,
            "chip": peaks.get("chip"),
            "estimate": bool(peaks.get("estimate"))}


def wire_utilization(bytes_on_wire, step_seconds, peaks=None,
                     cross_host=False):
    """Collective bytes/s against the interconnect roof (the intra-node
    link, or the cross-node one). Returns ``(fraction, gbytes_per_s)`` or
    ``(None, None)``."""
    if not bytes_on_wire or not step_seconds or step_seconds <= 0:
        return None, None
    peaks = peaks or chip_peaks()
    gbs = bytes_on_wire / step_seconds / 1e9
    roof = peaks.get("dcn_gbs" if cross_host else "ici_gbs") or 0.0
    return (gbs / roof if roof > 0 else None), gbs
