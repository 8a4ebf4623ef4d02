"""Homomorphic polynomial evaluation in the Chebyshev basis
(Paterson–Stockmeyer recursion over T_{2^k} giants, log-depth).

Backs CKKS bootstrapping's EvalMod (scaled sine) and the reference facade's
polynomial activations (CkksContext::poly_eval_relu_function /
poly_eval_step_function, fhe_ops_lib/fhe_lib_v2.h:1101-1135).

Scale discipline: products drift the scale by q_level/Δ per rescale; adds
align operands by dropping levels and *forcing* the smaller relative scale
difference into the message (SEAL-style set_scale), asserting the forced
error stays below ``SCALE_FORCE_TOL``. Exact Lattigo-style target-scale
steering can replace this without changing the API.
"""

import numpy as np

from .types import Ciphertext

SCALE_FORCE_TOL = 1e-3

# Bump when evaluation MATH changes (op sequence / rounding), so cached
# bootstrap host-walk boundaries (benchmarks/bootstrap_chip.py) are
# invalidated. 2 = round-5 leaf/baby pre-drop steering cut + giant trim.
EVAL_VERSION = 2


def chebyshev_interpolate(f, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev series coefficients of f on [a, b] (degree+1 terms)."""
    k = np.arange(degree + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (degree + 1))
    vals = f((b - a) / 2 * nodes + (b + a) / 2)
    # DCT-based projection
    coeffs = np.empty(degree + 1)
    for j in range(degree + 1):
        coeffs[j] = 2.0 / (degree + 1) * np.sum(vals * np.cos(np.pi * j * (k + 0.5) / (degree + 1)))
    coeffs[0] /= 2.0
    return coeffs


def cheb_divmod(c: np.ndarray, g: int):
    """p = q·T_g + r in the Chebyshev basis (deg r < g)."""
    c = np.array(c, dtype=np.float64)
    d = len(c) - 1
    q = np.zeros(max(d - g + 1, 1))
    for i in range(d, g, -1):
        ci = c[i]
        if ci == 0.0:
            continue
        q[i - g] += 2.0 * ci
        c[i] = 0.0
        c[abs(i - 2 * g)] -= ci
    if d >= g:
        q[0] += c[g]
        c[g] = 0.0
    return q, c[:g]


def eval_chebyshev_plain(coeffs, y):
    """Clenshaw reference evaluation (oracle for tests)."""
    b1 = b2 = 0.0
    for c in coeffs[::-1][:-1]:
        b1, b2 = 2 * y * b1 - b2 + c, b1
    return y * b1 - b2 + coeffs[0]


class ChebyshevEvaluator:
    """Evaluate Σ c_i·T_i((2x-(a+b))/(b-a)) on a CKKS ciphertext."""

    def __init__(self, engine, coeffs, a: float, b: float,
                 baby_log: int | None = None, pre_normalized: bool = False,
                 limb_step: int = 1):
        """``pre_normalized``: the operand already lives on [-1, 1] (the
        caller folded the affine map into an upstream constant, e.g. the
        bootstrap CoeffsToSlots post-scale) — saves one level.

        ``limb_step``: limbs consumed per multiplicative level. 1 for
        chains whose primes match the working scale (the u64 layout);
        2 for the 32-bit-word engine, where the working scale ≈ 2^62
        spans a PAIR of 31-bit primes and every rescale drops two limbs
        (composite scaling — the 32-bit-word bootstrap's level unit)."""
        self.engine = engine
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.a, self.b = float(a), float(b)
        self.pre_normalized = pre_normalized
        self.step = int(limb_step)
        if pre_normalized:
            assert abs(a + b) < 1e-12, 'pre-normalized domain must be symmetric'
        d = len(self.coeffs) - 1
        m = max((d).bit_length(), 1)
        self.baby_log = baby_log if baby_log is not None else (m + 1) // 2
        # Giants needed by the recursion: T_{2^(bl+1)} .. T_{2^(m-1)}
        # (the top divmod block is 2^(m-1); babies already provide
        # T_{2^bl}). range(bl, m) built one EXTRA giant T_{2^m} that no
        # divmod ever reads — one wasted ct-ct mult at the deepest
        # (most expensive) level of every evaluation (round-5 fix;
        # outputs are bit-identical, the entry was simply never used).
        self.giant_logs = list(range(self.baby_log, m - 1))

    # ---- scale-targeted level plan ---------------------------------------
    # Backward plan (Lattigo-style): σ(ℓ) := sqrt(σ(ℓ-1)·q_ℓ). A product of
    # two σ(ℓ) operands rescales to σ(ℓ)²/q_ℓ = σ(ℓ-1) EXACTLY, so any two
    # recursion branches meeting at a level carry identical scales by
    # construction — stable under mixed prime sizes (the forward recurrence
    # σ²/q squares deviations and diverges). The sqrt damps the anchor
    # choice; anchored at the EvalMod/entry magnitude.
    def _qstep(self, level: int) -> float:
        """Product of the ``step`` primes a rescale chain from ``level``
        divides by (q_level for step 1; q_level·q_{level-1} for pairs)."""
        q = self.engine.q
        out = 1.0
        for j in range(level - self.step + 1, level + 1):
            out *= float(q[j])
        return out

    def _rescale(self, xp, ct):
        for _ in range(self.step):
            ct = self.engine.rescale(xp, ct)
        return ct

    def _plan_scales(self, anchor: float):
        q = self.engine.q
        sigma = {lv: float(anchor) for lv in range(self.step)}
        for lv in range(self.step, len(q)):
            sigma[lv] = float(np.sqrt(sigma[lv - self.step] * self._qstep(lv)))
        self._sigma = sigma

    def planned_scale(self, level: int, anchor: float) -> float:
        """The plan's scale at ``level`` — upstream producers (bootstrap
        CoeffsToSlots) steer onto this so the evaluator enters on-plan
        without spending a level."""
        self._plan_scales(anchor)
        return self._sigma[level]

    def _to_level(self, xp, ct, level: int):
        """Bring ct down to ``level`` landing exactly on σ(level): free
        drops to level+step, then one steering constant multiply."""
        if ct.level == level:
            return ct
        eng = self.engine
        if ct.level > level + self.step:
            ct = eng.drop_level(xp, ct, ct.level - level - self.step)
        pt_scale = self._sigma[level] * self._qstep(ct.level) / ct.scale
        pt = eng.encode_const(1.0, ct.level, pt_scale, xp)
        out = self._rescale(xp, eng.mult(xp, ct, pt))
        out.scale = self._sigma[level]
        return out

    def _align(self, xp, cts: list) -> list:
        level = min(c.level for c in cts)
        return [self._to_level(xp, c, level) for c in cts]

    def _add(self, xp, x, y):
        x, y = self._align(xp, [x, y])
        return self.engine.add(xp, x, y)

    def _add_const(self, xp, ct, value: float):
        eng = self.engine
        pt = eng.encode_const(value, ct.level, ct.scale, xp)
        return eng.add(xp, ct, pt)

    def _mul_const(self, xp, ct, value: float, rescale=True):
        """Constant multiply landing exactly on σ(level-step)."""
        eng = self.engine
        pt_scale = (self._sigma[ct.level - self.step]
                    * self._qstep(ct.level) / ct.scale)
        pt = eng.encode_const(value, ct.level, pt_scale, xp)
        out = eng.mult(xp, ct, pt)
        if not rescale:
            return out
        out = self._rescale(xp, out)
        out.scale = self._sigma[out.level]
        return out

    def _mult(self, xp, x, y, rlk):
        x, y = self._align(xp, [x, y])
        out = self._rescale(xp, self.engine.relinearize(
            xp, self.engine.mult(xp, x, y), rlk))
        # x.scale·y.scale/Πq ≡ σ(ℓ-step) by the plan; pin the float exactly
        out.scale = self._sigma[out.level]
        return out

    # ---- basis -----------------------------------------------------------
    def _basis_babies(self, xp, ct, rlk):
        """T_1 = affine(x); babies T_2..T_{2^bl}."""
        a, b = self.a, self.b
        if self.pre_normalized:
            y = ct
        else:
            y = self._mul_const(xp, ct, 2.0 / (b - a))
            y = self._add_const(xp, y, -(a + b) / (b - a))
        T = {1: y}
        for k in range(1, 1 << self.baby_log):
            if k + 1 in T or k + 1 == 1:
                continue
            half, other = (k + 1) // 2, k + 1 - (k + 1) // 2
            if half == other:
                t = self._mult(xp, T[half], T[half], rlk)
                t = self._add(xp, t, t)                       # 2T²
                T[k + 1] = self._add_const(xp, t, -1.0)       # −T_0
            else:
                # T_a T_b = (T_{a+b} + T_{a−b})/2
                t = self._mult(xp, T[half], T[other], rlk)
                t = self._add(xp, t, t)
                diff = other - half
                if diff == 0:
                    T[k + 1] = self._add_const(xp, t, -1.0)
                else:
                    # pre-drop T_diff so its -1 multiply lands exactly on
                    # t's (level, scale) — no align steer in the add
                    td = T[diff]
                    if td.level > t.level + self.step:
                        td = self.engine.drop_level(
                            xp, td, td.level - t.level - self.step)
                    corr = self._mul_const(xp, td, -1.0)
                    T[k + 1] = self._add(xp, t, corr)
        return T

    def _basis_giants(self, xp, T, rlk):
        for lg in self.giant_logs:
            src = 1 << lg
            t = self._mult(xp, T[src], T[src], rlk)
            t = self._add(xp, t, t)
            T[2 * src] = self._add_const(xp, t, -1.0)
        return T

    def _basis(self, xp, ct, rlk):
        return self._basis_giants(xp, self._basis_babies(xp, ct, rlk), rlk)

    # canonical basis-key orders for the staged evaluation boundaries
    def _baby_keys(self):
        return sorted({1} | set(range(2, (1 << self.baby_log) + 1)))

    def _all_keys(self):
        return sorted(set(self._baby_keys())
                      | {2 << lg for lg in self.giant_logs})

    def _eval_rec(self, xp, coeffs, T, rlk):
        d = len(coeffs) - 1
        if d < (1 << self.baby_log):
            # direct: c_0 + Σ c_i T_i at a common level/scale. Each term
            # is PRE-DROPPED to the common target level so its single
            # constant multiply lands exactly on σ(common) — the naive
            # form (mul_const at T_i's own level, then align in the add)
            # paid one extra steering multiply + rescale chain per
            # level-mismatched term, ~25-30 extra rescale chains across a
            # deg-39 EvalMod (round-5 cut; values differ only in one
            # fewer rounding, precision re-pinned by the bootstrap tests).
            idx = [i for i in range(1, d + 1) if abs(coeffs[i]) >= 1e-14]
            const = coeffs[0]
            if not idx:
                base = self._mul_const(xp, T[1], 0.0)
                return self._add_const(xp, base, float(const))
            eng = self.engine
            common = min(T[i].level for i in idx) - self.step
            terms = []
            for i in idx:
                t = T[i]
                if t.level > common + self.step:
                    t = eng.drop_level(xp, t, t.level - common - self.step)
                terms.append(self._mul_const(xp, t, float(coeffs[i])))
            out = terms[0]
            for t in terms[1:]:
                out = eng.add(xp, out, t)        # same level+scale by plan
            return self._add_const(xp, out, float(const))
        g = 1 << (d.bit_length() - 1)
        q, r = cheb_divmod(coeffs, g)
        qc = self._eval_rec(xp, q, T, rlk)
        rc = self._eval_rec(xp, r, T, rlk)
        out = self._mult(xp, qc, T[g], rlk)
        return self._add(xp, out, rc)

    def _enter(self, xp, ct):
        """Steer onto the plan: one steering multiply if off by > 1e-9."""
        sig = self._sigma[ct.level]
        if abs(ct.scale - sig) / sig > 1e-9:
            eng = self.engine
            pt_scale = (self._sigma[ct.level - self.step]
                        * self._qstep(ct.level) / ct.scale)
            pt = eng.encode_const(1.0, ct.level, pt_scale, xp)
            ct = self._rescale(xp, eng.mult(xp, ct, pt))
            ct.scale = self._sigma[ct.level]
        return ct

    def __call__(self, xp, ct: Ciphertext, rlk, anchor: float | None = None) -> Ciphertext:
        self._plan_scales(anchor or ct.scale)
        ct = self._enter(xp, ct)
        T = self._basis(xp, ct, rlk)
        return self._eval_rec(xp, self.coeffs, T, rlk)

    def stages(self, anchor: float):
        """The evaluation as [(suffix, fn)] with
        fn(xp, cts: list[Ciphertext], rlk) -> list[Ciphertext]; folding in
        order is op-for-op identical to ``__call__(..., anchor=anchor)``.

        Exists so a caller can put jit/compile boundaries INSIDE the
        evaluation: the fused full-size (n=2^16) bootstrap EvalMod program
        ran a compiler out of memory even const-lifted — the three
        sub-programs (baby basis / giant basis / PS recursion) each
        compile. Boundaries carry the live basis entries in canonical key
        order (``_baby_keys``/``_all_keys``)."""
        def s_babies(xp, cts, rlk):
            ct, = cts
            self._plan_scales(anchor)
            T = self._basis_babies(xp, self._enter(xp, ct), rlk)
            return [T[k] for k in self._baby_keys()]

        def s_giants(xp, cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._baby_keys(), cts))
            T = self._basis_giants(xp, T, rlk)
            return [T[k] for k in self._all_keys()]

        # The PS recursion split once more: the fused recursion program is
        # the largest sub-stage (154k jaxpr eqns at the n=2^16 profile —
        # the same size class that ran the compiler out of memory).
        # 'l' evaluates every divmod-tree LEAF (constant multiplies only),
        # 'e' walks the tree combining them (the ct-ct giant multiplies).
        # Same ops, same operands, different emission order — values are
        # identical to the fused recursion.
        def _tree(coeffs):
            d = len(coeffs) - 1
            if d < (1 << self.baby_log):
                return ('leaf', coeffs)
            g = 1 << (d.bit_length() - 1)
            q, r = cheb_divmod(coeffs, g)
            return ('node', g, _tree(q), _tree(r))

        tree = _tree(self.coeffs)

        def _leaves(node, out):
            if node[0] == 'leaf':
                out.append(node[1])
            else:
                _leaves(node[2], out)
                _leaves(node[3], out)
            return out

        n_leaves = len(_leaves(tree, []))

        def _node_gs(node, out):
            if node[0] == 'node':
                out.add(node[1])
                _node_gs(node[2], out)
                _node_gs(node[3], out)
            return out

        # basis entries the combine stage multiplies by: every divmod
        # block size in the tree (giants AND the top baby T_{2^bl})
        comb_keys = sorted(_node_gs(tree, set()))

        def s_leaves(xp, cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._all_keys(), cts))
            leaf_cts = [self._eval_rec(xp, c, T, rlk)
                        for c in _leaves(tree, [])]
            return leaf_cts + [T[k] for k in comb_keys]

        def s_combine(xp, cts, rlk):
            self._plan_scales(anchor)
            leaf_cts = list(cts[:n_leaves])
            T = dict(zip(comb_keys, cts[n_leaves:]))
            it = iter(leaf_cts)

            def walk(node):
                if node[0] == 'leaf':
                    return next(it)
                qc = walk(node[2])
                rc = walk(node[3])
                return self._add(xp, self._mult(xp, qc, T[node[1]], rlk), rc)
            return [walk(tree)]

        def s_eval(xp, cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._all_keys(), cts))
            return [self._eval_rec(xp, self.coeffs, T, rlk)]

        out = [('b', s_babies)]
        if self.giant_logs:
            out.append(('g', s_giants))
        if tree[0] == 'node':
            out += [('l', s_leaves), ('e', s_combine)]
        else:
            out.append(('e', s_eval))
        return out


def poly_eval_relu(engine, xp, ct, rlk, degree: int = 15,
                   bound: float = 1.0):
    """Smooth ReLU ≈ x·sigmoid-ish via Chebyshev (reference
    poly_eval_relu_function semantics: polynomial ReLU approximation)."""
    ev = ChebyshevEvaluator(engine,
                            chebyshev_interpolate(lambda t: np.maximum(t, 0.0),
                                                  -bound, bound, degree),
                            -bound, bound)
    return ev(xp, ct, rlk)


def poly_eval_step(engine, xp, ct, rlk, degree: int = 15,
                   bound: float = 1.0):
    """Polynomial step/sign approximation (reference poly_eval_step_function)."""
    ev = ChebyshevEvaluator(engine,
                            chebyshev_interpolate(
                                lambda t: (np.tanh(20 * t) + 1) / 2,
                                -bound, bound, degree),
                            -bound, bound)
    return ev(xp, ct, rlk)
