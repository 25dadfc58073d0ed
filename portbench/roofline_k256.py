"""The least time one compose2 can take on one H100 at sec=128, k=256
(|Delta| of 2341 bits: L = 160, Lm = 296), and the least time of each
launch of the kernels' wide instances, the ones for rows of 289 to 320
limbs.

The per-kernel work is `roofline.py`'s, unchanged: its per-limb counts and
byte counts at this configuration's widths. Only the trip counts are this
file's: the means recorded on the card at 512 lanes on compose2's
operands in the CoFHE nodes' part-decryptions at k=256 (forms of the
wNAF ladder). `compose2_bounds` sums the same kernel instances as
`roofline.compose2_bounds`, so a change that fuses or replaces kernels
is measured against the same work.
"""

from __future__ import annotations

from portbench import roofline as r

# per-lane trip means at 512 lanes, recorded on an H100 over the 1432
# compose2s of one part-decryption's eager ladder at k=256 (a 1221-bit
# share, 512 distinct powers of h): K1 groups at each width, K2
# iterations, K3 groups, KT steps, and the share of lanes K6d takes from
# the width-8 pipeline
TRIPS = {"k1": {"Lxn": 35.79, "Lh": 46.15, "L": 0.0, "W8": 0.03},
         "k2": 67.61, "k3": 28.26, "kt": 0.04, "fits8": 0.4326}


def k2(B: int, Lx: int, Lm: int) -> float:
    """K2 at B lanes: x (B, Lx) mod m (B, Lm), the recorded iterations over
    the live window of ceil((Lm + 3) / 32) limbs a thread."""
    window = 32 * ((Lm + 3 + 31) // 32)
    return r.bound_ms(B * TRIPS["k2"] * window * r.OPS_K2, 4.0 * B * (2 * Lx + Lm))


def compose2_bounds(B: int, w: dict) -> dict:
    """{kernel instance: bound ms} of one compose2 at B lanes, as
    roofline.compose2_bounds counts them, with this file's trips."""
    L, Lh, Lxn, Lm = w["L"], w["Lh"], w["Lxn"], w["Lm"]
    out = {}
    for key, W in (("Lxn", Lxn), ("L", L), ("Lh", Lh), ("W8", w["W8"])):
        out[f"K1 W={W}"] = r.bound_ms(B * TRIPS["k1"][key] * r.K1_STEPS * W * r.OPS_K1,
                                      4.0 * B * W * 5)
    out["K2"] = k2(B, Lm, L)
    out["K3"] = r.bound_ms(B * TRIPS["k3"] * L * r.OPS_K3, 4.0 * B * L * 6)
    out["KT"] = r.bound_ms(B * TRIPS["kt"] * L * r.OPS_KT, 4.0 * B * (6 * L + 2))
    for name, (La, Lb, Lo) in products(w).items():
        out[f"K5m {name}"] = r.k5m(B, La, Lb, Lo)
    for name, (Ly, Lo) in {"xi": (L, Lh), "m2": (Lh, L), "a1g": (Lh, Lh),
                           "c3": (Lm, L)}.items():
        out[f"K5d {name}"] = r.k5d(B, Ly, Lo)
    for i in range(3):
        out[f"K4 {Lh} #{i}"] = r.k4(B, Lh, Lh, Lh)
    out["K4 8"] = r.k4(B, w["W8"], w["W8"], Lh)
    out["K6a xi"] = r.k6a(B, L, [(B, Lh, False), (B, L, False)])
    out["K6a m2x2"] = r.k6a(B, L, [(B, L, False)])
    out["K6a b3"] = r.k6a(B, L, [(B, L, True), (B, L, False)], W_shr=w["Lsq"])
    out["K6a csum"] = r.k6a(B, Lm, [(B, Lm, False), (1, w["Ldelta"], False)])
    out["K6b"] = r.k6b(B, L, Lh, Lxn)
    out["K6c"] = r.k6c(B, L, Lxn, Lh, B)
    out["K6d"] = r.k6d(B, w["W8"], Lh, round(TRIPS["fits8"] * B))
    out["K6e"] = r.k6e(B, L, Lm)
    return out


def products(w: dict) -> dict:
    """compose2's seven products, name -> (La, Lb, Lo)."""
    L, Lh = w["L"], w["Lh"]
    return {"u": (Lh, L, w["Lu"]), "eta0*s": (Lh, Lh, L), "t2": (Lh, L, L),
            "a3": (Lh, L, L), "t": (Lh, L, L), "t1": (w["Lu"], Lh, w["Lm"]),
            "sq": (w["Lsq"], w["Lsq"], w["Lm"])}


def compose2_bound_ms(B: int, widths: dict) -> float:
    """The least time of one compose2 at B lanes (the sum of its kernels'
    bounds)."""
    return sum(compose2_bounds(B, widths).values())


def wide_sites(B: int, widths: dict) -> dict:
    """{kernel: [bound ms of each launch of its wide instance in one compose2
    at B lanes]}: K2's mu, K5m's t1 and sq, K6a's csum and K6e, the rows
    of compose2 that pass 288 limbs at k=256."""
    b = compose2_bounds(B, widths)
    return {"mod_topdown": [b["K2"]], "mag_mul": [b["K5m t1"], b["K5m sq"]],
            "canon_sm": [b["K6a csum"]], "c3_operands": [b["K6e"]]}
