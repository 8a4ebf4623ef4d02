"""FHE parameter sets (BFV / CKKS / CKKS-bootstrap).

The default prime chains are the reference's canonical table
(reference: frontend/parameter.json, loaded at frontend/custom_task.py:167)
— the conformance oracles depend on these exact primes. On top of the
declared chain, the runtime derives device-side constants:

- the auxiliary BEHZ basis for BFV multiplication (NTT-friendly ~59-bit
  primes distinct from q ∪ p, plus m_sk and the power-of-two m̃),
- per-level Δ_ℓ = floor(Q_ℓ/t) tables for BFV encoding,
- hybrid key-switching digit structure (α = |p| special primes).

Security note: parameter security follows the reference's table choices
(Lattigo default logQP budgets); custom parameters are the caller's
responsibility, as in the reference.
"""

import functools
import json
import math
import os

_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'parameter.json')
MTILDE_BITS = 16
MTILDE = 1 << MTILDE_BITS


@functools.lru_cache(maxsize=None)
def _load_table():
    with open(_TABLE_PATH) as f:
        return json.load(f)


class FheParams:
    """Common runtime parameter base (reference: fhe_ops_lib/fhe_lib_v2.h:193-308)."""

    algo = ''

    def __init__(self, n: int, q: list[int], p: list[int],
                 word_bits: int = 64):
        self.n = int(n)
        self.logn = self.n.bit_length() - 1
        if 1 << self.logn != self.n:
            raise ValueError(f'n must be a power of two, got {n}')
        self.q = [int(x) for x in q]
        self.p = [int(x) for x in p]
        self.max_level = len(self.q) - 1
        # Machine word for all RNS arithmetic (core/u64.py): 64 (default)
        # or 32 for sub-2^31 prime chains (create_tpu_param).
        self.word_bits = int(word_bits)
        if self.word_bits == 32 and any(x >= (1 << 31) for x in self.q + self.p):
            raise ValueError('word_bits=32 requires all primes < 2^31')

    @property
    def max_sp_level(self) -> int:
        return len(self.p) - 1

    def q_prod(self, level: int) -> int:
        return math.prod(self.q[:level + 1])

    @property
    def p_prod(self) -> int:
        return math.prod(self.p)

    def level_of(self, n_limbs: int) -> int:
        return n_limbs - 1

    def __eq__(self, other):
        return (type(self) is type(other) and self.__dict__ == other.__dict__)

    def __hash__(self):
        return hash((self.algo, self.n, tuple(self.q), tuple(self.p),
                     self.word_bits))


def _recut31_capped(log_q: int, log_p: int) -> tuple[int, int]:
    """Split a logQP budget into 31-bit limb counts WITHOUT exceeding it:
    total limbs are floored into the budget, so the re-cut chain's security
    tier can never drop below the source chain's (the HE-standard tables
    bound TOTAL modulus bits — a ceiling re-cut overshoots them by up to
    60 bits, utils/security.py). The q/p split keeps the source chain's
    proportion; on 31-bit words the hybrid key-switch digit size equals
    |P| by construction (keys.py alpha = len(p)), so P ≈ digit product and
    the noise contract holds for any npr — npr is purely the
    digits-vs-carried-limbs performance knob (benchmarks/alpha_sweep.py)."""
    total = (log_q + log_p) // 31
    npr = max(1, min(total - 1, round(total * log_p / (log_q + log_p))))
    return total - npr, npr


class BfvParams(FheParams):
    algo = 'BFV'

    def __init__(self, n: int, t: int, q: list[int], p: list[int],
                 word_bits: int = 64):
        super().__init__(n, q, p, word_bits)
        self.t = int(t)

    @classmethod
    def create(cls, n: int, t: int | None = None) -> 'BfvParams':
        """Default chain from the canonical table (BfvParameter::create_parameter)."""
        entry = _load_table()['BFV'][str(n)]
        return cls(n, t if t is not None else entry['t'], entry['q'], entry['p'])

    @classmethod
    def create_custom(cls, n: int, t: int, q: list[int], p: list[int],
                      word_bits: int = 64) -> 'BfvParams':
        return cls(n, t, q, p, word_bits)

    @classmethod
    def create_tpu_param(cls, n: int, t: int | None = None) -> 'BfvParams':
        """31-bit-word parameter profile: the default chain's logQP budget
        re-cut into 31-bit NTT primes with word_bits=32, so every modmul
        runs on 32-bit words (core/u64.py). Mirrors the reference's FPGA
        profile, which pins hardware-word-sized prime chains
        (frontend/custom_task.py:215 create_fpga_parameter).

        The limb counts are FLOORED into the default chain's logQP budget
        (never over it — the standard security tables bound total modulus
        bits), with P kept >= the default chain's special-prime bits (the
        key-switch noise contract); q takes the remainder.
        """
        entry = _load_table()['BFV'][str(n)]
        nq, npr = _recut31_capped(
            sum(int(x).bit_length() for x in entry['q']),
            sum(int(x).bit_length() for x in entry['p']))
        from .core.modring import gen_ntt_primes
        primes = gen_ntt_primes(n, 31, nq + npr)
        return cls(n, t if t is not None else entry['t'],
                   primes[:nq], primes[nq:], word_bits=32)

    @classmethod
    def create_tpu_custom(cls, n: int, t: int, log_q: int,
                          log_p: int) -> 'BfvParams':
        """31-bit chain meeting the requested budgets as MINIMUMS (limb
        counts are ceiled, so logQP may exceed log_q+log_p by up to 60
        bits); warns when that overshoots the ring's 128-bit table row —
        use create_tpu_param for the security-classed profile."""
        from .core.modring import gen_ntt_primes
        from .utils.security import check_security
        nq = -(-log_q // 31)
        npr = max(1, -(-log_p // 31))
        primes = gen_ntt_primes(n, 31, nq + npr)
        out = cls(n, t, primes[:nq], primes[nq:], word_bits=32)
        check_security(out, stacklevel=3)
        return out

    def delta(self, level: int) -> int:
        """Δ_ℓ = floor(Q_ℓ / t) — BFV plaintext scaling at level ℓ."""
        return self.q_prod(level) // self.t


class CkksParams(FheParams):
    algo = 'CKKS'

    def __init__(self, n: int, q: list[int], p: list[int],
                 slots: int | None = None, scale: float = 0.0,
                 word_bits: int = 64):
        super().__init__(n, q, p, word_bits)
        self.slots = int(slots) if slots else n // 2
        if self.slots & (self.slots - 1) or not (0 < self.slots <= n // 2):
            raise ValueError(f'slots must be a power of two in (0, n/2], got {slots}')
        self.scale = float(scale) if scale else float(q[-1])

    @classmethod
    def create(cls, n: int) -> 'CkksParams':
        entry = _load_table()['CKKS'][str(n)]
        return cls(n, entry['q'], entry['p'], entry['slots'], entry['scale'])

    @classmethod
    def create_custom(cls, n: int, q: list[int], p: list[int],
                      slots: int | None = None, scale: float = 0.0,
                      word_bits: int = 64) -> 'CkksParams':
        return cls(n, q, p, slots, scale, word_bits)

    @classmethod
    def create_tpu_param(cls, n: int, slots: int | None = None) -> 'CkksParams':
        """31-bit-word CKKS profile: the default chain's logQP budget re-cut
        into 31-bit NTT primes with word_bits=32 and scale ≈ 2^30 (rescale
        prime size). Mirrors the reference's CKKS FPGA profile, which pins
        31-bit q chains and a 2^31 scale for the hardware word
        (frontend/custom_task.py:273 CkksParam.create_fpga_param). Limb
        counts are floored into the default chain's logQP budget (see
        BfvParams.create_tpu_param)."""
        from .core.modring import gen_ntt_primes
        entry = _load_table()['CKKS'][str(n)]
        nq, npr = _recut31_capped(
            sum(int(x).bit_length() for x in entry['q']),
            sum(int(x).bit_length() for x in entry['p']))
        primes = gen_ntt_primes(n, 31, nq + npr)
        return cls(n, primes[:nq], primes[nq:],
                   slots or entry.get('slots'), float(1 << 30), word_bits=32)

    @classmethod
    def create_tpu_btp_param(cls, n: int = 65536,
                             slots: int | None = None) -> 'CkksParams':
        """31-bit-word BOOTSTRAP-capable profile: a uniform 31-bit chain for
        the composite-scaling bootstrap (BootstrapConfig limbs_per_level=2:
        working scales ≈2^62 span prime pairs, ModRaise lifts from the
        composite base q0·q1 — every operation runs in 32-bit words,
        schemes/bootstrap.py).

        Budget: 48 q + 4 p limbs (logQP ≈ 1612 at n=2^16) sized for the
        reference full-profile circuit quality (k=20, sine_deg=39,
        double_angle=3, arcsine) with 8 limbs (4 multiplicative levels)
        usable after bootstrap. That is ~66 bits over the reference's
        N16QP1546 budget but inside the n=2^16 128-bit classical bound
        used by production libraries (~1792; utils/security.py estimates
        128-bit for this set). Drop the arcsine (−4 limbs) or two spare
        levels to match the reference budget exactly.
        """
        from .core.modring import gen_ntt_primes
        from .utils.security import check_security
        nq, npr = 48, 4
        primes = gen_ntt_primes(n, 31, nq + npr)
        out = cls(n, primes[:nq], primes[nq:], slots, float(1 << 30),
                  word_bits=32)
        # logQP ≈ 1612 sits inside the n=2^16 128-bit convention bound
        # (~1792, utils/security.py); warn loudly if a resize breaks that
        check_security(out, stacklevel=3)
        return out

    def set_log_slots(self, log_slots: int):
        self.slots = 1 << log_slots

    @property
    def log_slots(self) -> int:
        return self.slots.bit_length() - 1


def params_from_task_json(parameter: dict, word_bits: int = 64) -> FheParams:
    """Rebuild runtime params from a mega_ag.json 'parameter' blob
    (schema: frontend/custom_task.py:2307-2331). Bootstrap tasks carry
    btp_* fields; they are attached as ``params.btp`` so the runtime can
    validate/construct a matching bootstrapper config. ``word_bits``: the
    RNS word the executing engine should use — the blob itself is
    word-agnostic (the task runtime adopts the caller context's word)."""
    if 't' in parameter:
        return BfvParams(parameter['n'], parameter['t'], parameter['q'],
                         parameter['p'], word_bits=word_bits)
    p = CkksParams(parameter['n'], parameter['q'], parameter['p'],
                   parameter.get('slots'), parameter.get('scale', 0.0),
                   word_bits=word_bits)
    if 'btp_cts_depth' in parameter:
        p.btp = {k: v for k, v in parameter.items() if k.startswith('btp_')}
    return p


@functools.lru_cache(maxsize=None)
def bfv_aux_basis(n: int, q: tuple[int, ...], p: tuple[int, ...],
                  word_bits: int = 64) -> tuple[tuple[int, ...], int]:
    """Auxiliary basis (B, m_sk) for BEHZ BFV multiplication.

    NTT-friendly primes at the word size (~59-bit, or 31-bit in narrow
    mode) distinct from the declared chain, plus one m_sk. Sized so every
    per-level prefix B_ℓ exceeds the scaled tensor-product bound
    8·t·n·Q_ℓ (BehzMult slices the prefix it needs per level).
    """
    from .core.modring import gen_ntt_primes

    bit_size = 31 if word_bits == 32 else 59
    # narrow primes carry ~half the bits, so roughly twice as many are
    # needed for the same bound; +2 covers slack at every level.
    count = (len(q) + 2 if word_bits == 64
             else (sum(x.bit_length() for x in q) + 34) // (bit_size - 1) + 2)
    primes = gen_ntt_primes(n, bit_size, count, exclude=tuple(q) + tuple(p))
    return tuple(primes[:-1]), primes[-1]
