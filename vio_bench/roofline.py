"""The least time each hand-written kernel's work needs on one H100, from the
cell's shapes: the larger of the bytes its function moves (each input read
once, each output written once) at the HBM rate and its operations, each
type at its own peak, summed.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: HBM 3.35
TB/s; float32 67 TFLOP/s outside the tensor cores; TF32 495 and bfloat16
989 TFLOP/s on them. int32: 132 SMs x 64 lanes x 1.98 GHz (the Hopper white
paper's INT32 units per SM at the data sheet's boost clock).

Operations per output pixel or pair, counted from each function as
written (an add, subtract, multiply, divide, min, max, abs, sqrt or
compare one each; an n-tap filter n multiplies and n - 1 adds):
  shi_tomasi  Scharr 16 + 3 products + 3 blurs of 7 taps 78 + eigenvalue 10
              + the 5x5 NMS 25 = 132
  harris      16 + 3 + 78 + det - 0.04 tr^2 7 + NMS = 129
  dog         blurs of 7 and 9 taps 26 + 34 + |difference| 2 + NMS = 87
  hessian     blur 26 + Scharr 16, of gx 16, of gy (y only) 8 + det 3 + NMS = 94
  fast        ring - centre 16 + bright 9-arc score 143 + dark score 144
              + max 1 + NMS = 329
  _gradmag2   blur 26 + Scharr 16 + gx^2 + gy^2 3 = 45 (no NMS)
  FED step    5-tap blur 18, Scharr 16, conductivity 6, flux over 4
              neighbours 19, update 2 = 61
  match pair  a.b as 3xTF32 (three TF32 products of 2 D) + distance 4 +
              row top-2 2 + column minimum 1 = 7 float32; gated 6 more
  draw value  the threefry hash: 2 key adds, 20 rounds of add, rotate and
              xor, 5 injections of 2 adds, then the words' xor, the shift
              and the OR into the exponent = 75 int32 (the logs, an add
              and a compare per value issue beside them and are left out)
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int32": 16.7e12}

RESPONSE_FLOP_PER_PX = {"shi_tomasi": 132, "harris": 129, "dog": 87, "hessian": 94,
                        "fast": 329, "_gradmag2": 45}
FED_FLOP_PER_PX_STEP = 61
MATCH_FLOP_PER_PAIR = 7
GATE_FLOP_PER_PAIR = 6
THREEFRY_INT32_OPS_PER_VALUE = 75


def bound_s(nbytes: float, ops: dict) -> float:
    """max(bytes at the HBM rate, sum of each type's operations at its peak)."""
    return max(nbytes / HBM_BYTES_PER_S, sum(n / PEAK[t] for t, n in ops.items()))


def response_nms_s(family: str, B: int, H: int, W: int) -> float:
    """One call over B images of H x W: the image read, the NMS'd and the
    raw response written (no NMS output for `_gradmag2`)."""
    px = B * H * W
    per_px = 8 if family == "_gradmag2" else 12
    return bound_s(per_px * px, {"fp32": RESPONSE_FLOP_PER_PX[family] * px})


def match_bytes(D: int, K: int, N: int, pairs: int, a_sets: int, gated: bool) -> int:
    """Each A set and each B set with its mask (and positions, gated) read
    once; min1, min2, arg1 (K) and colarg (N) written per pair."""
    per_row = 4 * D + 1 + (8 if gated else 0)
    return per_row * (a_sets * K + pairs * N) + pairs * (12 * K + 4 * N)


def match_top2_s(pairs: int, K: int, N: int, D: int, gated: bool) -> float:
    """One call over `pairs` pairs, each with its own A."""
    per_pair = K * N
    ops = {"tf32": 3 * 2 * D * per_pair * pairs,
           "fp32": (MATCH_FLOP_PER_PAIR + (GATE_FLOP_PER_PAIR if gated else 0)) * per_pair * pairs}
    return bound_s(match_bytes(D, K, N, pairs, pairs, gated), ops)


def threefry_categorical_s(keys: int, paths: int, draws: int, M: int) -> float:
    """One call: `keys` keys x `paths` paths x `draws` draws over M logits,
    the int64 indices written, each key's logits, key and index read."""
    values = keys * paths * draws * M
    nbytes = keys * paths * draws * 8 + keys * (M * 4 + 8 + 4)
    return bound_s(nbytes, {"int32": THREEFRY_INT32_OPS_PER_VALUE * values})


def fed_evolve_s(B: int, H: int, W: int, steps: int) -> float:
    """One FED cycle of `steps` steps over B fields: each field and its
    contrast factor read once, the field written once."""
    px = B * H * W
    return bound_s(8 * px + 4 * B, {"fp32": FED_FLOP_PER_PX_STEP * px * steps})


def fed_steps(T: float, tau_max: float = 0.25) -> int:
    """The steps of a FED cycle reaching diffusion time T."""
    return int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1


def step_bounds(system: dict, B: int, H: int, W: int) -> dict:
    """Per kernel, the least seconds of one batched step of B sequences:
    every call the step makes (levels, the main and rescue solves)."""
    fe, be = system["frontend"], system["backend"]
    levels = [(H >> lv, W >> lv) for lv in range(fe["levels_used"])]
    K = fe["grid_rows"] * fe["grid_cols"] * (fe["kp_per_cell"]
                                             + fe["kp_per_cell_coarse"] * (fe["levels_used"] - 1))
    D = 256 if fe["descriptor"] == "brief" else 128
    out = {
        "response_nms": sum(response_nms_s(fe["detector"], B, h, w) for h, w in levels),
        "match_top2": match_top2_s(B, K, K, D, False) + match_top2_s(B, K, K, D, True),
        "threefry_categorical": 2 * threefry_categorical_s(B, 2, be["ransac_hyps"], K),
    }
    if fe["scale_space"] == "nonlinear":
        out["response_nms"] += response_nms_s("_gradmag2", B, H, W)
        T0 = 0.5 * max(1.6 ** 2 - 1.0, 0.1)
        T1 = 1.5 * 1.6 ** 2
        out["fed_evolve"] = fed_evolve_s(B, H, W, fed_steps(T0)) + sum(
            fed_evolve_s(B, H, W, fed_steps(T1)) for _ in range(fe["levels_used"] - 1))
    return out


def share(ctx, op: str, kernels) -> "float | None":
    """100 x the least time of the traced steps' calls of `op` over the
    device time of the kernels whose names contain one of `kernels`; None
    where the trace holds none of them or the cell makes no such call."""
    t = ctx.trace
    bound = step_bounds(ctx.system, ctx.B, ctx.H, ctx.W).get(op)
    if t is None or bound is None:
        return None
    dev = t.device_s(lambda name: any(k in name for k in kernels))
    return 100.0 * t.steps * bound / dev if dev > 0 else None
