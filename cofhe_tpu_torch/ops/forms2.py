"""v2 batched Gauss composition + reduction on balanced redundant limbs
(torch port of cofhe_tpu/ops/forms2.py).

The algebra and the widths are the JAX package's:

* identity fast path: lanes whose a == 1 are substituted by two different
  fixed non-identity forms (h on one side, h^2 on the other) and the result
  is selected afterwards;
* first gcd d1 = gcd(a2, a1) with the a1-coefficient mod a2, two-tier in
  width (narrow Lxn pass, full-width pass for the rare lanes that do not
  fit);
* second gcd g = gcd(d1, |s|) via Montgomery REDC at width 8, with a
  full-width rare path, and xi from the exact identity
  xi = (g - eta0*|s|) / d1;
* mu = [u*(b2-b1) - 2*w*c1] mod 2*m2 with one top-down reduction;
* reduction: estimate-driven rho-descent (grouped or per-quotient) and the
  exact tail (`cuda_group.reduce_exact`: KT, or `forms.reduce_batch` on
  the CPU); or, opt-in as in the JAX package
  (`COFHE_NUCOMP=1` or `CG(..., use_nucomp=True)`), the NUCOMP tail: a
  Lehmer walk down the continued fraction of mu / 2m2
  (`cuda_group.lehmer_euclid`: K7, or `rl.lehmer_euclid` on the CPU) and
  the nearly reduced form built from its cofactors, which the
  rho-descent then finishes at width Ln.

Every `xgcd_coeff_g`, `mod_topdown`, grouped-rho loop, exact tail,
product (`lb.mag_mul`), exact quotient (`lb.mag_divexact_odd`), REDC
(`CG._redc_mod`), Lehmer walk, signed sum canonicalized (xi's numerator,
2 m2, b3 with b3 / 2, csum, and the NUCOMP tail's cofactors and form
values: `cuda_group.canon_sm`), the prologue up to s and dd with the
first gcd's operands (`CG.compose2_prologue`), the selects between the
two gcds (`cuda_group.gcd_bridge`), the second gcd's merge
(`cuda_group.gcd2_merge`) and c3's operands (`cuda_group.c3_operands`)
goes through the dispatchers of ops/cuda_group.py: on a CUDA tensor they
launch the Hopper kernels (K1, K2, K3, KT, K5m, K5d, K4, K7, K6a-K6e), on
a CPU tensor they run the plain torch versions (ops/compose2_plain.py
for K3 and K6b-K6e). On the card no 2-adic inverse runs inside compose2:
K5d and K4 take their own 16-bit inverses. Reduced forms are unique, so
the outputs equal the JAX package's and the pure-Python oracle's bit for
bit.

On a CUDA device, `CG.compose2` with the grouped reduction, with or
without NUCOMP, replays one captured CUDA graph per batch size
(ops/graphs.py), the counterpart of the JAX engine's jitted steps: that
compose2 reads no value on the host, so the whole step is one device
program. Its kernels form a DAG: `CG.compose2_unreduced` forks the chains
that lie off its critical path onto the device's side streams (`_Dag`,
graphs.side_streams), which the graph captures as parallel branches.
On the CPU, and with `grouped=False`, compose2 runs eagerly
(`CG.compose2_eager`, the body every capture runs); the v1 code is eager.

The rho loops in torch ops test their exit condition on the host every
`SYNC_EVERY` iterations; their bodies are fixed points on finished lanes,
and the JAX iteration caps are kept.
"""

from __future__ import annotations

import os

import torch

from . import cuda_group
from . import limb as lb
from . import rl
from .forms import BForm, bform_from_numpy, bform_select
from .graphs import ComposeGraphs, side_streams

I32 = torch.int32
F32 = torch.float32

SYNC_EVERY = rl.SYNC_EVERY


def _renorm_est(m, t):
    """Renormalize a (mant f32, top int32) estimate so |mant| lands back
    in ~[1, 2^16) (zero mant passes through)."""
    sh = (rl.log2f_i(m) >> 4).clamp(-4, 4)
    z = m == 0.0
    return (torch.where(z, m, m * rl.pow2f(-16 * sh)),
            torch.where(z, t, t + sh))


def _flags(ma, ta, mb, tb, mc, tc):
    """(need_norm, need_rho) of the rho-descent from value estimates."""
    bitsA = rl.bits_est(ma, ta)
    bitsB = rl.bits_est(mb, tb)
    bitsC = rl.bits_est(mc, tc)
    raw_norm = bitsB > bitsA + 0.25
    # quotients above ~25 bits fall to the exact tail
    freak = bitsB - bitsA > 25.0
    need_rho = ~raw_norm & (bitsC < bitsA - 0.25)
    return raw_norm & ~freak, need_rho


def _c_est(ma, ta, mb, tb, dD_mant: float, dD_top: int):
    """(mant, top) of c = (b^2 + |Delta|) / (4a) from the estimates of a
    and b via the discriminant invariant (the direct update
    c' = c + q*(q*a - b) cancels catastrophically, the invariant never)."""
    t2b = 2 * tb
    tbig = t2b.clamp(min=dD_top)
    m1 = (mb * mb) * rl.pow2f((16 * (t2b - tbig)).clamp(-126, 0))
    m2 = dD_mant * rl.pow2f((16 * (dD_top - tbig)).clamp(-126, 0))
    mc = (m1 + m2) / (4.0 * ma).clamp(min=1e-30)
    return _renorm_est(mc, tbig - ta)


def grouped_rho_loop(a_red, b_red, c_red, dD_mant: float, dD_top: int,
                     red_iters: int, iters=None):
    """The grouped rho-descent loop (plain version of K3): simulate up to 3
    normalization/rho quotients per group on (mant, top) scalar estimates,
    accumulating a unimodular M = [[p, q], [r, s]] with entries below 2^12,
    then apply M once to the limb tensors:
        a' = a p^2 + b p r + c r^2
        b' = 2 a p q + b (p s + q r) + 2 c r s
        c' = a q^2 + b q s + c s^2
    with 13+12-bit split coefficients. Inputs must be a genuine form of the
    discriminant |Delta| = dD_mant * 2^(16 dD_top); returns the redundant
    (a, b, c) after at most red_iters groups. Estimate noise can only waste
    a group; the exact tail finishes. `iters`, if given, receives each
    lane's number of groups."""
    sim_steps = 3
    lim = 4096  # 2^12 matrix-entry bound

    def ests(a, b):
        ma, ta = rl.value_est(a)
        mb, tb = rl.value_est(b)
        mc, tc = _c_est(ma, ta, mb, tb, dD_mant, dD_top)
        nn, nr = _flags(ma, ta, mb, tb, mc, tc)
        return ma, ta, mb, tb, nn | nr

    def coefmul(coef, v, v13):
        s = torch.sign(coef)
        u = coef.abs()
        return ((u & 0x1FFF) * s)[..., None] * v \
            + ((u >> 13) * s)[..., None] * v13

    a, b, c = rl.carry2(a_red), rl.carry2(b_red), rl.carry2(c_red)
    ma, ta, mb, tb, lane = ests(a, b)
    count = torch.zeros_like(ta)
    for it in range(red_iters):
        if it % SYNC_EVERY == 0 and not bool(lane.any()):
            break
        count = count + lane.to(I32)
        p = torch.ones_like(ta)
        r = torch.zeros_like(ta)
        qq = torch.zeros_like(ta)
        ss = torch.ones_like(ta)
        sma, sta, smb, stb = ma, ta, mb, tb
        for _ in range(sim_steps):
            mc_e, tc_e = _c_est(sma, sta, smb, stb, dD_mant, dD_top)
            need_norm, need_rho = _flags(sma, sta, smb, stb, mc_e, tc_e)
            act = lane & (need_norm | need_rho)
            do_rho = act & need_rho
            man = torch.where(do_rho, mc_e, sma)
            tan = torch.where(do_rho, tc_e, sta)
            mbn = torch.where(do_rho, -smb, smb)
            # matrix right-multiplied by rho = [[0,-1],[1,0]]
            p2 = torch.where(do_rho, qq, p)
            qq2 = torch.where(do_rho, -p, qq)
            r2 = torch.where(do_rho, ss, r)
            ss2 = torch.where(do_rho, -r, ss)
            # digit q ~ b/2a, clipped to the remaining matrix budget
            ratio = mbn / (2.0 * man).clamp(min=1e-30)
            scale = rl.pow2f((16 * (stb - tan)).clamp(-126, 60))
            col1 = torch.maximum(p2.abs(), r2.abs())
            col2 = torch.maximum(qq2.abs(), ss2.abs())
            qcap = torch.div(lim - col2, col1.clamp(min=1),
                             rounding_mode="floor").to(F32)
            qf = torch.minimum(torch.maximum(torch.round(ratio * scale),
                                             -qcap), qcap)
            qf = torch.where(act, qf, 0.0)
            qi = qf.to(I32)
            # b <- b - 2 q a at b's scale, renormalized
            inv = rl.pow2f((16 * (tan - stb)).clamp(-126, 60))
            smb, stb = _renorm_est(mbn - 2.0 * qf * man * inv, stb)
            sma, sta = man, tan
            p, r = p2, r2
            qq, ss = qq2 - qi * p2, ss2 - qi * r2
        a13 = rl.carry_pass(a << 13)
        b13 = rl.carry_pass(b << 13)
        c13 = rl.carry_pass(c << 13)

        def xform(ca, cb, cc):
            return rl.carry_pass(coefmul(ca, a, a13) + coefmul(cb, b, b13)
                                 + coefmul(cc, c, c13))

        a, b, c = (xform(p * p, p * r, r * r),
                   xform(2 * p * qq, p * ss + qq * r, 2 * r * ss),
                   xform(qq * qq, qq * ss, ss * ss))
        ma, ta, mb, tb, lane = ests(a, b)
    if iters is not None:
        iters.copy_(count)
    return a, b, c


class _Branch:
    """One forked chain of compose2: `join()` returns its result, having
    made the caller's stream wait for the chain's last launch on the card."""

    __slots__ = ("out", "done", "cur")

    def __init__(self, out, done=None, cur=None):
        self.out, self.done, self.cur = out, done, cur

    def join(self):
        if self.done is not None:
            self.cur.wait_event(self.done)
            self.done = None
        return self.out


class _Dag:
    """The fork sites of one compose2 (CG.compose2_unreduced). On a CUDA
    tensor `fork(fn, *args)` makes one of the device's two side streams
    (graphs.side_streams) wait for what the caller's current stream has
    queued, enqueues fn(*args) there, marks fn's output tensors as used by
    the caller's stream (record_stream: the allocator reuses them only
    after the caller's last use), and records an event that the branch's
    `join()` makes the caller's stream wait for; it holds the side
    streams' lock meanwhile, so no capture in another thread takes in its
    launches. The forks alternate between the two side streams, so two
    branches forked one after the other run beside each other. Inside a
    capture the side streams join it by these waits and allocate from the
    graph's pool. The caller keeps fn's inputs alive until the join (in
    compose2 they are its locals), so that no allocation on its stream
    reuses them while the side stream may still read them. On the CPU
    `fork` runs fn in line. `forks` counts the fork sites passed, on
    either route."""

    def __init__(self, ref: torch.Tensor):
        self.forks = 0
        self.cur = self.sides = None
        if ref.device.type == "cuda":
            self.cur = torch.cuda.current_stream(ref.device)
            self.sides = side_streams(ref.device)

    def fork(self, fn, *args) -> _Branch:
        self.forks += 1
        if self.sides is None:
            return _Branch(fn(*args))
        lock, *streams = self.sides
        side = streams[self.forks % 2]
        with lock:
            side.wait_stream(self.cur)
            with torch.cuda.stream(side):
                out = fn(*args)
            for t in out if isinstance(out, tuple) else (out,):
                t.record_stream(self.cur)
            return _Branch(out, side.record_event(), self.cur)


class CGCtx:
    """Static widths for one discriminant."""

    @staticmethod
    def widths_for_disc_bits(disc_bits: int):
        L = (disc_bits + 16 * 6) // 16 + 1
        L = ((L + 7) // 8) * 8
        Lh = (disc_bits // 2 + 64) // 16 + 1
        Lh = ((Lh + 7) // 8) * 8
        return L, Lh


def _r8(limbs: int) -> int:
    return ((limbs + 7) // 8) * 8


class CG:
    """Per-discriminant kernel family on one torch device: the widths, the
    constant |Delta|/4 and the two substitute forms h, h^2 of the identity
    fast path. `use_nucomp` selects the NUCOMP tail; None reads the JAX
    package's switch COFHE_NUCOMP (=1 on) at construction. On a CUDA
    device compose2, NUCOMP or not, replays a captured graph a batch size
    (ops/graphs.py)."""

    def __init__(self, disc_bits: int, delta4: torch.Tensor, h: BForm,
                 h2: BForm, use_nucomp: bool | None = None):
        if use_nucomp is None:
            use_nucomp = os.environ.get("COFHE_NUCOMP", "0") == "1"
        self.use_nucomp = use_nucomp
        self.compose_graphs = ComposeGraphs(self)
        self.device = delta4.device
        self.disc_bits = disc_bits
        L, Lh = CGCtx.widths_for_disc_bits(disc_bits)
        self.L, self.Lh = L, Lh
        self.delta4 = delta4  # (2L,) magnitude of |Delta|/4
        self.delta4_row = delta4[None]  # (1, 2L): one row for every lane
        # |Delta| as a (mant, top) estimate for the grouped-rho sim
        d4int = sum(int(v) << (16 * i) for i, v in enumerate(delta4.tolist()))
        dD = 4 * d4int
        tD = max((dD.bit_length() - 1) // 16, 0)
        sh = max(dD.bit_length() - 48, 0)
        self.dD_mant = float(dD >> sh) * (2.0 ** (sh - 16 * tD))
        self.dD_top = int(tD)
        self.h, self.h2 = h, h2
        self.xgcd_nbits = disc_bits + 32
        self.mu_iters = (2 * 16 * L) // 13 + 24
        self.red_iters = (2 * disc_bits) // 13 + 96
        # worst-case intermediate widths (see the JAX package's CG):
        # u = xi*beta <= 3D/2 bits, u*(b2-b1) <= 2D+2 bits, b3/2 <= D bits
        self.Lu = _r8((3 * disc_bits // 2 + 48 + 15) // 16)
        self.Lm = max(_r8((2 * disc_bits + 34 + 15) // 16), L + 8)
        self.Lsq = min(_r8((disc_bits + 19 + 15) // 16), L)
        # NUCOMP numerators a3 x^2, b3 x y, c3 y^2: ~2D + bits(y)^2 with the
        # lehmer_euclid y-cap, Lm and a margin; the Lehmer walk's group cap
        self.Ln = self.Lm + 8
        self.eu_groups = disc_bits // 16 + 48
        # narrow width of the first gcd (rotated-in c2 exceeds it only with
        # probability ~2^-400 for random class-group elements)
        self.Lxn = min(_r8(Lh + 16), L)
        # the fork sites the last compose2 passed (_Dag)
        self.branches = 0

    @classmethod
    def from_arrays(cls, disc_bits: int, delta4, h_rows, h2_rows,
                    device, use_nucomp: bool | None = None) -> "CG":
        """CG from the numpy arrays a JAX `CG` holds: `delta4` (2L,) and
        the rows (a, b_sign, b, c) of h and h^2."""
        d4 = torch.as_tensor(delta4).to(device=device, dtype=I32)
        return cls(disc_bits, d4, bform_from_numpy(*h_rows, device),
                   bform_from_numpy(*h2_rows, device), use_nucomp=use_nucomp)

    # ------------------------------------------------------------- reduce
    def reduce2(self, a_red, b_red, c_red, grouped: bool = True) -> BForm:
        """Reduction front-end: the grouped rho-descent or the per-quotient
        loop, then the exact tail. Inputs must be a genuine form of this
        discriminant (the grouped sim derives c from b^2 - 4ac = Delta)."""
        if grouped:
            return self.reduce2_grouped(a_red, b_red, c_red)
        return self.reduce2_iter(a_red, b_red, c_red)

    @property
    def tail_iters(self) -> int:
        """The exact tail's iteration cap (the JAX package's)."""
        return self.disc_bits // 4 + 64

    def _tail(self, a, b, c) -> BForm:
        """The exact tail: the unique reduced form of redundant (a, b, c)
        (KT on the card)."""
        return cuda_group.reduce_exact(a, b, c, self.tail_iters)

    def reduce2_grouped(self, a_red, b_red, c_red) -> BForm:
        """Grouped rho-descent (`compose2_plain.grouped_rho_loop_wide`, K3
        on the card), then the exact tail."""
        return self._tail(*cuda_group.reduce2_grouped_loop(
            a_red, b_red, c_red, self.dD_mant, self.dD_top, self.red_iters))

    def reduce2_iter(self, a_red, b_red, c_red) -> BForm:
        """Estimate-driven rho-descent, one quotient per iteration (|q| up
        to 2^27, applied with a 14+14 split); returns a reduced canonical
        BForm. a_red, c_red positive redundant, b_red signed redundant."""

        a, b, c = rl.carry2(a_red), rl.carry2(b_red), rl.carry2(c_red)
        ma, ta = rl.value_est(a)
        mb, tb = rl.value_est(b)
        mc, tc = rl.value_est(c)
        need_norm, need_rho = _flags(ma, ta, mb, tb, mc, tc)
        for it in range(self.red_iters):
            active = need_norm | need_rho
            if it % SYNC_EVERY == 0 and not bool(active.any()):
                break
            rho = need_rho[..., None]
            a, c = torch.where(rho, c, a), torch.where(rho, a, c)
            bn = torch.where(rho, -b, b)
            man = torch.where(need_rho, mc, ma)
            tan = torch.where(need_rho, tc, ta)
            mbn = torch.where(need_rho, -mb, mb)
            ratio = mbn / (2.0 * man).clamp(min=1e-30)
            scale = rl.pow2f((16 * (tb - tan)).clamp(-126, 29))
            qd = torch.round(ratio * scale).clamp(-134217000.0, 134217000.0)
            qd = torch.where(active, qd.to(I32), 0)
            a14 = rl.carry_pass(a << 14)
            s = torch.sign(qd)
            aq_ = qd.abs()
            lo = ((aq_ & 0x3FFF) * s)[..., None]
            hi = ((aq_ >> 14) * s)[..., None]
            aq = rl.carry_pass(rl.carry_pass(lo * a) + rl.carry_pass(hi * a14))
            b = rl.carry_pass(bn - 2 * aq)
            t = rl.carry_pass(aq - bn)
            t14 = rl.carry_pass(t << 14)
            c = rl.carry_pass(c + rl.carry_pass(lo * t)
                              + rl.carry_pass(hi * t14))
            ma, ta = man, tan
            mb, tb = rl.value_est(b)
            mc, tc = rl.value_est(c)
            need_norm, need_rho = _flags(ma, ta, mb, tb, mc, tc)
        return self._tail(a, b, c)

    # ------------------------------------------------------------ compose
    def compose2(self, F1: BForm, F2: BForm, grouped: bool = True) -> BForm:
        """F1 * F2 reduced. On a CUDA device with `grouped`, a replay of
        this batch size's captured graph (the NUCOMP tail too); otherwise
        eager."""
        if grouped and F1.a.is_cuda:
            return self.compose_graphs.run(F1, F2)
        return self.compose2_eager(F1, F2, grouped)

    def compose2_eager(self, F1: BForm, F2: BForm, grouped: bool = True) -> BForm:
        (a3, b3s, b3m, c3, a1g, m2x2, mu,
         id1, id2) = self.compose2_unreduced(F1, F2)
        if self.use_nucomp:
            out = self._nucomp_tail(a3, b3s, b3m, c3, a1g, m2x2, mu, grouped)
        else:
            out = self.reduce2(a3, b3s[..., None] * b3m, c3, grouped=grouped)
        # identity selects (both identities: F2 is the identity, so the
        # first select already returns it)
        out = bform_select(id2 & ~id1, F1, out)
        return bform_select(id1, F2, out)

    def nudupl2(self, F: BForm, grouped: bool = True) -> BForm:
        return self.compose2(F, F, grouped=grouped)

    def _redc_mod(self, x, d, active, inv=None):
        """x * 2^(-16 Lh) mod d, canonical in [0, d), for odd d: K4 on the
        card; on the CPU rl.redc_mod, with inv = d^-1 mod 2^(16 Lh) when
        the caller has it (cuda_group.redc_mod)."""
        return cuda_group.redc_mod(x, d, self.Lh, active, inv)

    def compose2_prologue(self, F1: BForm, F2: BForm):
        """The identity masks, the substitution of h / h^2, the swap to
        a1 <= a2, F2 rotated odd, s = (b1 + b2)/2 and dd = b2 - b1:
        (a1, b1s, b1m, c1, a2, b2s, b2m, c2, ss, sm, dds, ddm, id1, id2),
        then, where the narrow width Lxn is below L, the first gcd's
        operands (fx, a2_n, a1_n, a2_w, a1_w); one launch of K6b on the
        card (compose2_plain.compose2_prologue_plain on the CPU)."""
        return cuda_group.compose_prologue(F1, F2, self.h, self.h2, self.Lh, self.Lxn)

    def compose2_unreduced(self, F1: BForm, F2: BForm):
        """Everything before the reduction: the unreduced composed
        coefficients (a3, b3s, b3m, c3), the NUCOMP tail's operands
        (a1g, m2x2, mu) and the identity masks (id1, id2), in the JAX
        function's order. It reads no value on the host.

        A DAG on the card: three chains off the critical path (the second
        gcd's width-8 pipeline; t2 with its term of mu_red; m2, a1g and
        m2x2) are forked onto side streams (_Dag) and joined where their
        results are first read; the critical path stays on the caller's
        stream. On the CPU each chain runs in line."""
        L, Lh = self.L, self.Lh
        (a1, b1s, b1m, c1, a2, b2s, b2m, c2, ss, sm, dds, ddm, id1,
         id2, *first) = self.compose2_prologue(F1, F2)
        dag = _Dag(a1)

        # first gcd: d1 = gcd(a2, a1), beta = a1-coefficient mod a2; the
        # narrow pass takes every lane whose operands fit 16*Lxn-32 bits,
        # the full-width pass the rest (its g is 0 on every other lane, so
        # those lanes leave its loop at once); K6b gave both passes'
        # operands
        if first:
            fx, a2_n, a1_n, a2_w, a1_w = first
            d1_n, beta_n = cuda_group.xgcd_coeff_g(a2_n, a1_n, a2_n, 16 * self.Lxn - 16)
            d1_w, beta_w = cuda_group.xgcd_coeff_g(a2_w, a1_w, a2_w,
                                                   self.xgcd_nbits)
            narrow = (d1_n, beta_n, fx)
        else:
            d1_w, beta_w = cuda_group.xgcd_coeff_g(a2.contiguous(), a1.contiguous(),
                                                   a2.contiguous(), self.xgcd_nbits)
            narrow = None

        # second gcd: g = gcd(d1, |s|), eta0 in [0, d1) with
        # eta0 * |s| ≡ g (mod d1). Width 8 when d1 < 2^120 (fits8), width
        # Lh on the rest but the identity lanes (rare); K6c merges d1 and
        # beta and gives both pipelines' divisors
        d1, beta, fits8, rare, d1_8, d1_8h, d1h = cuda_group.gcd_bridge(
            d1_w, beta_w, id1, id2, Lh, narrow)
        # On the CPU one 2-adic inverse of d1 serves both REDC pipelines and
        # xi below, and one of g both quotients (d1 is odd: it divides the
        # odd a2). On the card K4 and K5d take their own 16-bit inverses,
        # so no inverse is computed there.
        shared = cuda_group.plain_route(d1)
        inv_d1 = inv8 = invF = None
        if shared:
            inv_d1 = lb.inv_pow2(d1, Lh)
            one_h = lb.one_limbs(d1.shape[:-1], Lh, d1.device)
            inv8 = torch.where(fits8[..., None], inv_d1, one_h)
            invF = torch.where(rare[..., None], inv_d1, one_h)

        def pipeline8(sm, d1_8h, d1_8, fits8, inv8):
            # sm is |s| >> 1 at Lh limbs (the prologue's)
            rp_m = self._redc_mod(sm, d1_8h, fits8, inv8)
            g8, eta8 = cuda_group.xgcd_coeff_g(d1_8, rp_m[..., :8].contiguous(),
                                               d1_8, 136)
            # rp carries 2^(-16 Lh): eta8 * rp ≡ g, so the same scale
            # removal applies to eta8
            return g8, self._redc_mod(eta8, d1_8, fits8, inv8)

        # the width-8 pipeline beside the same pipeline at width Lh on the
        # rare rest (its xgcd leaves its loop at once when no lane needs
        # it; its REDCs run on every lane, and K6d drops the lanes outside
        # `rare`)
        p8 = dag.fork(pipeline8, sm, d1_8h, d1_8, fits8, inv8)
        rpF_m = self._redc_mod(sm, d1h, rare, invF)
        gF, etaF = cuda_group.xgcd_coeff_g(
            d1h, torch.where(rare[..., None], rpF_m, 0), d1h, 16 * Lh)
        eta0F = self._redc_mod(etaF, d1h, rare, invF)
        g8, eta0_8 = p8.join()
        g, eta0 = cuda_group.gcd2_merge(g8, eta0_8, gF, eta0F, fits8)

        def quotients(a2, a1, g):
            # m2 = a2/g, a1g = a1/g (g odd: divides odd a2 via d1)
            inv_g = lb.inv_pow2(g, L) if shared else None
            m2 = lb.mag_divexact_odd(a2, g, L, inv=inv_g)
            a1g = lb.mag_divexact_odd(a1, g, Lh, inv=inv_g)
            _, m2x2 = cuda_group.canon_sm([(m2, None, 2)], L)  # m2 << 1
            return m2, a1g, m2x2

        Lu, Lm = self.Lu, self.Lm

        def t2_term(eta0, c1, ss):
            # mu_red's second term, 2*sign(s)*t2 at Lm limbs, t2 = eta0*c1
            return 2 * (ss[..., None] * lb.resize(lb.mag_mul(eta0, c1, L), Lm))

        # beside the xi chain: t2's term, and the quotients by g
        t2_b = dag.fork(t2_term, eta0, c1, ss)
        quot = dag.fork(quotients, a2, a1, g)

        # xi = (g - eta0*|s|) / d1 exactly (integer identity); |xi| <= |s|
        prod_es = lb.mag_mul(eta0, sm, L)
        xi_s, tm = cuda_group.canon_sm([(g, None, 1), (prod_es, None, -1)], L)
        xi = lb.mag_divexact_odd(tm, d1, Lh, inv=inv_d1)

        # u = xi * beta ; mu_num = u*(b2-b1) - 2*sign(s)*eta0*c1
        u = lb.mag_mul(xi, beta, Lu)
        t1 = lb.mag_mul(u, ddm, Lm)
        mu_red = (xi_s * dds)[..., None] * t1 - t2_b.join()
        m2, a1g, m2x2 = quot.join()
        mu = lb.resize(cuda_group.mod_topdown(mu_red, m2x2, self.mu_iters), L)

        # a3 = a1g*m2 ; b3 = b1 + a1g*mu ; c3 = ((b3/2)^2 + |D|/4)/a3
        a3 = lb.mag_mul(a1g, m2, L)
        t = lb.mag_mul(a1g, mu, L)
        b3s, b3m, b3h = cuda_group.canon_sm([(b1m, b1s, 1), (t, None, 1)], L,
                                            shr=1, W_shr=self.Lsq)
        sq = lb.mag_mul(b3h, b3h, Lm)
        _, csum = cuda_group.canon_sm([(sq, None, 1), (self.delta4_row, None, 1)], Lm)
        # K6e: with e = v2(a3), csum >> e and a3 >> e, both at Lm limbs
        csum_sh, a3_odd = cuda_group.c3_operands(a3, csum)
        c3 = lb.mag_divexact_odd(csum_sh, a3_odd, L)
        self.branches = dag.forks
        return a3, b3s, b3m, c3, a1g, m2x2, mu, id1, id2

    def lehmer_operands(self, a1g, m2x2, mu):
        """The NUCOMP tail's Lehmer walk operands (r0, r1, bits_stop): 2m2
        and mu at width L, and the bits at which the walk stops."""
        mantB, topB = rl.value_est_ordered(m2x2)
        bitsB = rl.bits_est(mantB, topB)
        mantA, topA = rl.value_est_ordered(a1g)
        bitsA = rl.bits_est(mantA, topA)
        # T^2 ~ 2B * sqrt(|D|/4) / sqrt(A*B)
        bits_stop = 0.5 * (bitsB + 0.5 * (self.disc_bits - 2.0)
                           - 0.5 * (bitsA + bitsB - 1.0))
        return lb.resize(m2x2, self.L), lb.resize(mu, self.L), bits_stop

    def _nucomp_tail(self, a3, b3s, b3m, c3, a1g, m2x2, mu,
                     grouped: bool = True) -> BForm:
        """NUCOMP partial reduction: walk the continued fraction of
        mu / 2m2 with the Lehmer walk (K7 on the card) down to bits_stop
        (~ the bits of (|Delta|/4)^(1/4) * sqrt(2m2 / a1g)) and build the nearly reduced
        equivalent form from the cofactors z_i = (x_i, y_i):

            Q(z)  = a3 x^2 + b3 x y + c3 y^2       (the new a and c)
            cross = 2 a3 xp xc + b3 (xp yc + xc yp) + 2 c3 yp yc  (the new b)

        det [[xp, yp], [xc, yc]] = +-1; an improper transform conjugates the
        class, which negating b undoes. reduce2 then finishes at width Ln."""
        L, Ln = self.L, self.Ln
        _, _, xp, xc, yp, yc, par = cuda_group.lehmer_euclid(
            *self.lehmer_operands(a1g, m2x2, mu), self.eu_groups)
        # the cofactors stay under the walk's y-cap (<= 16 Lh bits), so
        # they are cut to Lh limbs before the products
        Lxy = min(self.Lh, L)
        (sxp, mxp), (sxc, mxc) = cuda_group.canon_sm([(xp, None, 1)], L,
                                                     terms2=[(xc, None, 1)])
        (syp, myp), (syc, myc) = cuda_group.canon_sm([(yp, None, 1)], L,
                                                     terms2=[(yc, None, 1)])
        mxp, mxc = lb.resize(mxp, Lxy), lb.resize(mxc, Lxy)
        myp, myc = lb.resize(myp, Lxy), lb.resize(myc, Lxy)

        def term(sa, ma, sb, mb, coeff_mag):
            return sa * sb, lb.mag_mul(lb.mag_mul(ma, mb), coeff_mag, Ln)

        def quad(sx, mx, sy, my):
            """The terms of a3 x^2 + b3 x y + c3 y^2 (a form value > 0)."""
            t1s, t1m = term(sx, mx, sx, mx, a3)
            t2s, t2m = term(sx, mx, sy, my, b3m)
            t3s, t3m = term(sy, my, sy, my, c3)
            return [(t1m, t1s, 1), (t2m, t2s * b3s, 1), (t3m, t3s, 1)]

        # both canonical in one launch
        (_, nA), (_, nC) = cuda_group.canon_sm(quad(sxp, mxp, syp, myp), Ln,
                                               terms2=quad(sxc, mxc, syc, myc))
        v1s, v1m = term(sxp, mxp, sxc, mxc, a3)
        v3s, v3m = term(syp, myp, syc, myc, c3)
        cs, cm = cuda_group.canon_sm([(lb.mag_mul(mxp, myc), sxp * syc, 1),
                                      (lb.mag_mul(mxc, myp), sxc * syp, 1)], 2 * Lxy)
        nB = (2 * v1s[..., None] * v1m
              + (cs * b3s)[..., None] * lb.mag_mul(cm, b3m, Ln)
              + 2 * v3s[..., None] * v3m)
        nB = (1 - 2 * (par & 1))[..., None] * nB
        red = self.reduce2(nA, nB, nC, grouped=grouped)
        # reduced coefficients fit L (c <= |Delta|/4); back to form width
        return BForm(lb.resize(red.a, L), red.b_sign, lb.resize(red.b, L),
                     lb.resize(red.c, L))
