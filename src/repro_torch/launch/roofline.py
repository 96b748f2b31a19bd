"""Roofline terms from a cell's recorded step (port of
``src/repro/launch/roofline.py``).

    compute term    = flops_per_device            / peak_FLOP/s
    memory term     = HBM_bytes_per_device        / HBM_bw
    collective term = wire bytes/dev within a node / NVLink_bw
                    + wire bytes/dev across nodes  / network_bw

``HW`` is one H100's and ``NET`` its node's (``launch.mesh``).  The
reference prices every collective at its ICI rate, which joins a whole TPU
pod; NVLink joins only a node's 8 GPUs, so a collective whose group's
ranks span more than one node (every group of the 16 x 16 and 2 x 16 x 16
meshes) is priced at one GPU's network rate, 50 GB/s against NVLink's 450.
Sources:
  * flops and collective bytes: ``hlo_analysis.analyze_trace`` over the
    ``Trace`` of ``steps.lower_cell`` (unrolled: every loop pass is in it);
  * memory term: the reference's analytic model of HBM traffic (weights,
    gradients, optimizer state, activation checkpoints, KV cache, logits),
    the same arithmetic;
  * ``memory_analysis``: the fake run's bytes on one device.  Arguments are
    the local shards of the parameters, optimizer state, batch and cache;
    outputs what the step returns or updates in place; alias the outputs
    that are arguments (the parameters the train step updates in place, the
    counterpart of donation); temp the peak live bytes less the arguments
    and the new outputs, so that ``argument + output + temp - alias`` (the
    reference's total) is the peak.  ``fits_80g`` holds it against the
    H100's 80 GB (the reference's ``fits_16g`` named its TPU's 16 GB).

The reference's ``*_xla_raw`` keys are XLA's own counts; here they are the
trace's own: ``flops_per_device_xla_raw`` the same products, and
``hbm_bytes_per_device_xla_raw`` the bytes every recorded op reads and
writes, unfused, a diagnostic only (as the reference's CPU count is).
"""
from __future__ import annotations

from repro_torch.launch.hlo_analysis import analyze_trace
from repro_torch.launch.mesh import HW, NET


# ---------------------------------------------------------------------------
# analytic HBM-traffic model (per device, bytes)
# ---------------------------------------------------------------------------
def analytic_hbm_bytes(cfg, spec, kind: str, n_devices: int) -> float:
    """First-principles HBM traffic for one step, assuming TPU-grade fusion:
    weights are read once per pass, activations spill only at layer
    boundaries (remat checkpoints), attention/CE are flash/chunk-fused."""
    P = cfg.n_params()
    P_active = cfg.n_active_params()
    B, S = spec.batch, spec.seq
    d = cfg.d_model
    L = cfg.n_layers
    dt = 2  # bf16

    if kind == "train":
        tokens_loc = B * S / n_devices
        p_loc = P / n_devices          # params fully sharded (FSDP x TP)
        # fwd read + remat recompute read + bwd read (transposed use)
        w_traffic = 3 * p_loc * dt
        # grads write+read (bf16), optimizer m/v read+write (f32 or int8), update
        g_traffic = 2 * p_loc * dt
        opt_bytes = 1.25 if P > 15e9 else 8.0   # int8 v (+scales) vs f32 m+v
        o_traffic = p_loc * (2 * 4 + 2 * opt_bytes)  # m rw + v rw
        # activation checkpoints: save + 2 reads per layer boundary
        act = 3 * L * tokens_loc * d * dt
        # CE logits (chunked, f32, vocab sharded over 'model'): w+r, fwd+bwd
        ce = 4 * tokens_loc * (cfg.vocab / min(n_devices, 16)) * 4
        return w_traffic + g_traffic + o_traffic + act + ce

    if kind == "prefill":
        tokens_loc = B * S / n_devices
        p_loc = P_active / n_devices
        act = L * tokens_loc * d * dt           # layer-boundary writes
        cache = _cache_bytes(cfg, B, S) / n_devices
        return p_loc * dt + act + cache

    # decode: weights + full cache read per token
    p_loc = P_active / n_devices * dt
    cache = _cache_bytes(cfg, B, S) / n_devices
    return p_loc + cache


def _cache_bytes(cfg, B: int, S: int) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            if cfg.mla:
                per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            total += B * S * per_tok * 2
        else:
            total += B * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim * 4
                          + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    return total


def memory_analysis(trace) -> dict:
    """The fake run's bytes on one device (the module's docstring)."""
    m = trace.memory
    new_out = m["output"] - m["alias"]
    temp = m["peak"] - m["argument"] - new_out
    total = m["argument"] + m["output"] + temp - m["alias"]
    return {
        "argument_bytes": int(m["argument"]),
        "output_bytes": int(m["output"]),
        "temp_bytes": int(temp),
        "alias_bytes": int(m["alias"]),
        "total_nonaliased_bytes": int(total),
        "fits_80g": total < HW["hbm_per_chip"],
    }


def roofline(trace, n_devices: int, *, cfg=None, spec=None,
             kind: str | None = None, model_flops: float | None = None,
             cost=None) -> dict:
    """The reference's record of one cell; ``cost`` is the trace's
    ``analyze_trace`` where the caller has it already."""
    parsed = cost if cost is not None else analyze_trace(trace, n_devices)
    flops_dev = parsed.flops
    bytes_dev_raw = parsed.bytes_accessed
    bytes_dev = (analytic_hbm_bytes(cfg, spec, kind, n_devices)
                 if cfg is not None else bytes_dev_raw)

    t_compute = flops_dev / HW["peak_flops"]
    t_memory = bytes_dev / HW["hbm_bw"]
    inter = parsed.coll_wire_bytes_internode
    t_coll = ((parsed.coll_wire_bytes - inter) / HW["ici_bw"]
              + inter / NET["net_bw"])
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bound = max(terms, key=terms.get)
    t_bound = terms[bound]
    out = {
        "flops_per_device": flops_dev,
        "flops_per_device_xla_raw": flops_dev,
        "hbm_bytes_per_device_analytic": bytes_dev,
        "hbm_bytes_per_device_xla_raw": bytes_dev_raw,
        "collective_wire_bytes_per_device": parsed.coll_wire_bytes,
        "collective_wire_bytes_per_device_internode": inter,
        "collective_counts": parsed.coll_counts,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound": bound,
        "roofline_step_s": t_bound,
        "compute_fraction_of_bound": (t_compute / t_bound) if t_bound > 0 else 0.0,
    }
    if model_flops is not None:
        out["model_flops_global"] = model_flops
        hlo_global = flops_dev * n_devices
        out["model_vs_hlo_flops"] = model_flops / hlo_global if hlo_global else 0.0
        out["mfu_at_roofline"] = (
            model_flops / (t_bound * n_devices * HW["peak_flops"]) if t_bound > 0 else 0.0
        )
    try:
        out["memory_analysis"] = memory_analysis(trace)
    except Exception as e:  # pragma: no cover
        out["memory_analysis"] = {"error": str(e)}
    return out


def model_flops_for(cfg, shape_spec, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params, D = tokens);
    2*N*D for inference forward."""
    n_active = cfg.n_active_params()
    tokens = shape_spec.batch * (shape_spec.seq if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
