"""The least time one compose2 can take on one H100: the work of every
kernel a compose2 launches, at the configuration's widths and a lane
count, over the card's peaks.

The per-limb operation counts and byte counts are a frozen copy of the
kernel table's bounds as the program's smoke script defined them when
this benchmark was written (its `bound`, `k5m_bound`, `k5d_bound`,
`k4_bound`, `k6a_bound` .. `k6e_bound` and the K1, K2, K3 and KT rows),
and the trip counts are the means recorded on the main path's operands
then: decrypt's steps (recorded at 128 lanes), the matmul's doubling
chain and finalization (256) and its ladder (16384). The work is counted
for compose2 as a whole, so a change that fuses or replaces kernels is
measured against the same work. Each kernel instance's bound is the
larger of its operations over their rate and its bytes over the memory
rate; a compose2's bound is their sum.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate; int32 as half the
# FP32 lanes of 67 TFLOP/s; dense int8 tensor-core rate
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
INT8_TC_OPS_PER_S = 1979e12

# int32 operations per limb and trip (the kernel table's counts)
OPS_K1 = 83 / 30   # a divstep and limb; a 30-divstep group is 83
K1_STEPS = 30      # divsteps a group
OPS_K2 = 36        # an iteration and window limb
OPS_K3 = 147       # a group and limb
OPS_KT = 170       # a step and limb
OPS_MAD, OPS_CARRY, OPS_STEP, OPS_K4_TAIL = 3, 25, 6, 40
OPS_TC_PAIR = 8    # four 8-bit multiply-adds a 16 x 16-bit limb pair
OPS_K6A, OPS_K6A_TERM, OPS_K6B_L = 28, 2, 4
OPS_K6_SEL, OPS_K6E = 2, 6

# compose2's widths at sec=128, k=128 (|Delta| of 2085 bits)
WIDTHS_SEC128_K128 = {"L": 144, "Lh": 72, "Lxn": 88, "Lu": 200, "Lm": 264,
                      "Lsq": 136, "W8": 8, "Ldelta": 288}

# per-lane trip means of the recorded operands, by the path they were
# recorded on: K1 groups at each width, K2 iterations, K3 groups, KT
# steps, and the share of lanes K6d takes from the width-8 pipeline
TRIPS = {
    "decrypt": {"k1": {"Lxn": 26.80, "Lh": 46.41, "L": 0.0, "W8": 0.0},
                "k2": 58.72, "k3": 25.19, "kt": 0.08, "fits8": 58 / 128},
    "chain": {"k1": {"Lxn": 11.07, "Lh": 62.07, "L": 0.0, "W8": 0.0},
              "k2": 58.68, "k3": 25.09, "kt": 0.02, "fits8": 47 / 256},
    "ladder": {"k1": {"Lxn": 73.0, "Lh": 0.0, "L": 0.0, "W8": 0.0},
               "k2": 59.0, "k3": 26.0, "kt": 0.0, "fits8": 1.0},
}


def bound_ms(ops: float, nbytes: float, tc_ops: float = 0.0) -> float:
    """ms of the larger of int32 operations (and tensor-core operations)
    over their rate and bytes over the memory rate."""
    t_ops = max(ops / INT32_OPS_PER_S, tc_ops / INT8_TC_OPS_PER_S)
    return max(t_ops, nbytes / MEM_BYTES_PER_S) * 1e3


def k5m_pairs(La: int, Lb: int, Lo: int) -> int:
    """Limb products a row of a product mod 2^(16 Lo)."""
    na, nb = min(La, Lo), min(Lb, Lo)
    return sum(max(0, min(c, na - 1) - max(0, c - nb + 1) + 1) for c in range(Lo))


def k5m(B, La, Lb, Lo):
    return bound_ms(B * Lo * OPS_CARRY, 4.0 * B * (min(La, Lo) + min(Lb, Lo) + Lo),
                    B * k5m_pairs(La, Lb, Lo) * OPS_TC_PAIR)


def k5d(B, Ly, Lo):
    ny = min(Ly, Lo)
    pairs = sum(min(ny, Lo - k) for k in range(Lo))
    return bound_ms(B * Lo * OPS_STEP, 4.0 * B * (Lo + ny + Lo), B * pairs * OPS_TC_PAIR)


def k4(B, Lx, Ld, steps):
    N = max(Lx, steps + Ld) + 1
    return bound_ms(B * (steps * OPS_STEP + N * (OPS_CARRY + OPS_K4_TAIL)),
                    4.0 * B * (2 * Lx + Ld) + B, B * steps * Ld * OPS_TC_PAIR)


def k6a(B, W, terms, W_shr=0):
    """terms: (rows, width, signed) of each term of one sum."""
    nbytes = ops = 0.0
    for rows, width, signed in terms:
        L = min(width, W)
        nbytes += 4.0 * rows * L + (4.0 * B if signed else 0.0)
        ops += OPS_K6A_TERM * B * L
    nbytes += 4.0 * B * (1 + W + W_shr)
    return bound_ms(ops + OPS_K6A * B * W, nbytes)


def k6b(B, L, Lh, Lxn):
    nbytes = 4.0 * B * 2 * (3 * L + 1) + 4.0 * B * (6 * L + 4 + 2 * Lh) + 2.0 * B
    ops = B * (2 * OPS_K6A * Lh + OPS_K6B_L * L)
    if Lxn < L:
        nbytes += 4.0 * B * (2 * Lxn + 2 * L) + B
        ops += OPS_K6_SEL * B * (2 * Lxn + 2 * L)
    return bound_ms(ops, nbytes)


def k6c(B, L, Lxn, Lh, n_narrow):
    rd = 2 * (n_narrow * Lxn + (B - n_narrow) * L)
    wr = B * (2 * L + 8 + 2 * Lh)
    return bound_ms(OPS_K6_SEL * wr, 4.0 * (rd + wr) + B * 5)


def k6d(B, W8, Lh, n_fits8):
    rd = 2 * (n_fits8 * W8 + (B - n_fits8) * Lh)
    return bound_ms(OPS_K6_SEL * 2 * B * Lh, 4.0 * (rd + 2 * B * Lh) + B)


def k6e(B, L, Lm):
    return bound_ms(B * (OPS_K6E * 2 * Lm + L + Lm), 4.0 * B * (L + 3 * Lm))


def compose2_bounds(B: int, widths: dict, path: str) -> dict:
    """{kernel instance: bound ms} of one compose2 at B lanes, with the
    trips recorded on `path` ("decrypt", "chain" or "ladder")."""
    w, tr = widths, TRIPS[path]
    L, Lh, Lxn, Lm = w["L"], w["Lh"], w["Lxn"], w["Lm"]
    out = {}
    for key, W in (("Lxn", Lxn), ("L", L), ("Lh", Lh), ("W8", w["W8"])):
        out[f"K1 W={W}"] = bound_ms(B * tr["k1"][key] * K1_STEPS * W * OPS_K1,
                                    4.0 * B * W * 5)
    window = 32 * ((L + 3 + 31) // 32)
    out["K2"] = bound_ms(B * tr["k2"] * window * OPS_K2, 4.0 * B * (2 * Lm + L))
    out["K3"] = bound_ms(B * tr["k3"] * L * OPS_K3, 4.0 * B * L * 6)
    out["KT"] = bound_ms(B * tr["kt"] * L * OPS_KT, 4.0 * B * (6 * L + 2))
    for name, (La, Lb, Lo) in {"u": (Lh, L, w["Lu"]), "eta0*s": (Lh, Lh, L),
                               "t2": (Lh, L, L), "a3": (Lh, L, L), "t": (Lh, L, L),
                               "t1": (w["Lu"], Lh, Lm),
                               "sq": (w["Lsq"], w["Lsq"], Lm)}.items():
        out[f"K5m {name}"] = k5m(B, La, Lb, Lo)
    for name, (Ly, Lo) in {"xi": (L, Lh), "m2": (Lh, L), "a1g": (Lh, Lh),
                           "c3": (Lm, L)}.items():
        out[f"K5d {name}"] = k5d(B, Ly, Lo)
    for i in range(3):
        out[f"K4 {Lh} #{i}"] = k4(B, Lh, Lh, Lh)
    out["K4 8"] = k4(B, w["W8"], w["W8"], Lh)
    out["K6a xi"] = k6a(B, L, [(B, Lh, False), (B, L, False)])
    out["K6a m2x2"] = k6a(B, L, [(B, L, False)])
    out["K6a b3"] = k6a(B, L, [(B, L, True), (B, L, False)], W_shr=w["Lsq"])
    out["K6a csum"] = k6a(B, Lm, [(B, Lm, False), (1, w["Ldelta"], False)])
    out["K6b"] = k6b(B, L, Lh, Lxn)
    out["K6c"] = k6c(B, L, Lxn, Lh, B)
    out["K6d"] = k6d(B, w["W8"], Lh, round(tr["fits8"] * B))
    out["K6e"] = k6e(B, L, Lm)
    return out


def compose2_bound_ms(B: int, widths: dict, path: str) -> float:
    """The least time of one compose2 at B lanes (the sum of its kernels'
    bounds)."""
    return sum(compose2_bounds(B, widths, path).values())
