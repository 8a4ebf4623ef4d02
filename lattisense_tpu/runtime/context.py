"""User-facing FHE contexts: key ownership + eager op facade.

This framework's equivalent of the reference's Handle-based contexts
(fhe_ops_lib/fhe_lib_v2.h:358-706 BfvContext, :831-1163 CkksContext): a
context owns the parameter set, the secret/public/evaluation keys, and
exposes encode/encrypt/decrypt plus eager evaluation ops. Unlike the
reference there is no foreign-handle table — ciphertexts are plain array
dataclasses (schemes/types.py), and the compiled path (runtime/task.py)
consumes the same keys as jit-traced arrays.

``make_public_context()`` drops the secret key for the server side of
client/server protocols (reference: fhe_lib_v2.h:392).
"""

import numpy as np

from ..params import BfvParams
from ..schemes import keys as K
from ..utils.csprng import default_crypto_rng
from ..schemes.bfv import BfvEngine
from ..schemes.ckks import CkksEngine
from ..schemes.galois import galois_elt_col, galois_elt_row
from ..schemes.types import GaloisKeys


class FheContext:
    """Base: key storage shared by BFV/CKKS (reference FheContext role)."""

    engine_cls = None

    def __init__(self, params, seed=None):
        self.params = params
        self.engine = self.engine_cls(params)
        # CSPRNG for all secret sampling (keys, noise, compressed-ct seeds);
        # reference parity: Lattigo's cryptographic samplers, not PCG64.
        self.rng = default_crypto_rng(seed)
        self.sk = None
        self.pk = None
        self.rlk = None
        self.glk = GaloisKeys()
        self.swk = {}              # name -> KeySwitchKey (bootstrap swk_dts/swk_std)

    # ---- key generation -------------------------------------------------
    @classmethod
    def create_random_context(cls, params, seed=None):
        """Sample sk/pk/rlk (reference: CreateRandomBfvContext path,
        fhe_lib_v2.cpp:85); deterministic when ``seed`` is given
        (create_random_context_with_seed parity, fhe_lib_v2.h:846)."""
        ctx = cls(params, seed)
        q, p, n = tuple(params.q), tuple(params.p), params.n
        wb = getattr(params, 'word_bits', 64)
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, wb)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, wb)
        return ctx

    @classmethod
    def create_empty_context(cls, params):
        """Keyless context (server side before keys arrive; reference
        CreateEmpty*Context)."""
        return cls(params)

    def gen_rotation_keys(self, level=None):
        """The reference's standard key set (gen_rotation_keys,
        fhe_lib_v2.h): every ±2^i column-rotation key plus the row key —
        enough for any NAF-composite `rotate_cols` step and `rotate_rows`.
        `level` is accepted for signature parity (keys here serve every
        level)."""
        n = self.params.n
        steps = []
        i = 1
        while i < n // 2:
            steps += [i, -i]
            i *= 2
        self.gen_rotation_keys_for_rotations(steps, swap_rows=True,
                                             level=level)

    def gen_rotation_keys_for_rotations(self, rotations, swap_rows=False, level=None):
        """Galois keys for the NAF power-of-two sub-rotations of each step
        (reference: GenBfvContextRotationKeysForRotations; decomposition
        mirrors the frontend's get_glk_col)."""
        from ..frontend.custom_task import get_glk_col
        q, p, n = tuple(self.params.q), tuple(self.params.p), self.params.n
        wb = getattr(self.params, 'word_bits', 64)
        for step in rotations:
            pos, negs = get_glk_col(step, n)
            sub_steps = [2 ** i for i in pos] + [-(2 ** i) for i in negs]
            for ss in sub_steps:
                if abs(ss) % (n // 2) == 0:
                    continue
                elt = galois_elt_col(ss, n)
                if elt not in self.glk.keys:
                    self.glk.keys[elt] = K.gen_galois_key(self.rng, self.sk, elt, q, p, n, wb)
        if swap_rows:
            elt = galois_elt_row(n)
            if elt not in self.glk.keys:
                self.glk.keys[elt] = K.gen_galois_key(self.rng, self.sk, elt, q, p, n, wb)

    def gen_galois_keys_for_elements(self, galois_elements):
        q, p, n = tuple(self.params.q), tuple(self.params.p), self.params.n
        wb = getattr(self.params, 'word_bits', 64)
        for elt in galois_elements:
            if elt not in self.glk.keys:
                self.glk.keys[elt] = K.gen_galois_key(self.rng, self.sk, elt, q, p, n, wb)

    def make_public_context(self):
        """Evaluation-only copy: public/eval keys, no secret key."""
        pub = type(self)(self.params)
        pub.pk, pub.rlk = self.pk, self.rlk
        # Shallow-copy the key containers so keys generated later on either
        # context never leak into (or mutate) the other.
        pub.glk = GaloisKeys(dict(self.glk.keys))
        pub.swk = dict(self.swk)
        return pub

    @property
    def is_public(self) -> bool:
        return self.sk is None

    # ---- serialization (reference: fhe_lib_v2.h:421-434) -----------------
    def serialize(self) -> bytes:
        """Context state without evaluation keys."""
        from ..utils.serialize import serialize_context
        return serialize_context(self, advanced=False)

    def serialize_advanced(self) -> bytes:
        """Context state including rlk/glk/btp switch keys."""
        from ..utils.serialize import serialize_context
        return serialize_context(self, advanced=True)

    @staticmethod
    def deserialize(blob: bytes):
        from ..utils.serialize import deserialize_context
        return deserialize_context(blob)

    deserialize_advanced = deserialize

    def serialize_ciphertext(self, ct, n_drop_bit_0: int = 0,
                             n_drop_bit_1: int = 0) -> bytes:
        from ..utils.serialize import serialize_ciphertext
        return serialize_ciphertext(ct, self.params, n_drop_bit_0, n_drop_bit_1)

    @staticmethod
    def deserialize_ciphertext(blob: bytes):
        from ..utils.serialize import deserialize_ciphertext
        return deserialize_ciphertext(blob)

    def encrypt_symmetric_compressed(self, pt, seed=None):
        if self.sk is None:
            raise RuntimeError(
                'Context does not have sk and the corresponding encryptor.')
        return self.engine.encrypt_symmetric_compressed(self.rng, self.sk, pt, seed)

    def compressed_ciphertext_to_ciphertext(self, cct):
        return self.engine.decompress_ciphertext(cct)

    # ---- argument validation (reference-verbatim error strings,
    #      unittests/test_lattigo.cpp:2049-2128) ---------------------------
    def _max_message_len(self) -> int:
        return self.params.n

    def _check_message(self, values, level):
        try:
            length = len(values)
        except TypeError:
            length = np.asarray(values).size
        if length == 0 or length > self._max_message_len():
            raise RuntimeError('Invalid message length.')
        if level is not None and not 0 <= level <= self.params.max_level:
            raise RuntimeError('Invalid level.')

    @staticmethod
    def _check_same_level(a, b):
        la, lb = getattr(a, 'level', None), getattr(b, 'level', None)
        if la is not None and lb is not None and la != lb:
            raise RuntimeError('x0 and x1 have different levels.')

    # ---- encode / encrypt / decrypt -------------------------------------
    def encode(self, values, level=None, **kw):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode(values, level, **kw)

    def encode_ringt(self, values, **kw):
        self._check_message(values, None)
        return self.engine.encode_ringt(values, **kw)

    def encode_mul(self, values, level=None, **kw):
        level = self.params.max_level if level is None else level
        self._check_message(values, level)
        return self.engine.encode_mul(values, level, **kw)

    def encrypt(self, pt):
        return self.engine.encrypt_asymmetric(self.rng, self.pk, pt)

    def encrypt_symmetric(self, pt):
        if self.sk is None:
            raise RuntimeError(
                'Context does not have sk and the corresponding encryptor.')
        return self.engine.encrypt_symmetric(self.rng, self.sk, pt)

    def decrypt(self, ct):
        if self.sk is None:
            raise RuntimeError('Context does not have sk and decryptor.')
        return self.engine.decrypt(self.sk, ct)

    def decrypt_decode(self, ct):
        if self.sk is None:
            raise RuntimeError('Context does not have sk and decryptor.')
        return self.engine.decrypt_decode(self.sk, ct)

    # ---- eager eval ops (host NumPy; device path goes through FheTask) ---
    def add(self, a, b):
        self._check_same_level(a, b)
        return self.engine.add(np, a, b)

    def sub(self, a, b):
        self._check_same_level(a, b)
        return self.engine.sub(np, a, b)

    def neg(self, a):
        return self.engine.neg(np, a)

    def mult(self, a, b):
        self._check_same_level(a, b)
        return self.engine.mult(np, a, b)

    def relinearize(self, ct3):
        if self.rlk is None:
            raise RuntimeError('Context does not have a relinearization key.')
        return self.engine.relinearize(np, ct3, self.rlk)

    def mult_relin(self, a, b):
        return self.relinearize(self.mult(a, b))

    def rescale(self, ct, *a, **kw):
        return self.engine.rescale(np, ct, *a, **kw)

    def _glk_for(self, elt: int):
        if elt not in self.glk.keys:
            raise RuntimeError(f'missing Galois key for element {elt}; call '
                               f'gen_rotation_keys_for_rotations first')
        return self.glk.keys[elt]

    def rotate_cols(self, ct, steps: int):
        """NAF-composite rotation (reference rotate_cols semantics:
        decompose steps into ±2^k sub-rotations, frontend get_glk_col)."""
        from ..frontend.custom_task import get_glk_col
        n = self.params.n
        pos, negs = get_glk_col(steps, n)
        out = ct
        for ss in [2 ** i for i in pos] + [-(2 ** i) for i in negs]:
            if abs(ss) % (n // 2) == 0:
                continue
            out = self._rotate_unit(out, ss)
        return out

    def advanced_rotate_cols(self, ct, steps):
        """Direct-key rotation; a list of steps returns {step: ct} with one
        shared hoisted decomposition (reference batch advanced_rotate_cols,
        fhe_lib_v2.h:702)."""
        if isinstance(steps, int):
            return self._rotate_unit(ct, steps)
        import numpy as np
        dct = self.engine.rns_sp_decomp(np, ct)
        out = {}
        for s in steps:
            elt = galois_elt_col(s, self.params.n)
            out[s] = self.engine.apply_galois_decomposed(np, dct, elt,
                                                         self._glk_for(elt))
        return out

    def get_coeff(self, ct, poly_idx: int, limb: int, coeff_idx: int) -> int:
        """Raw RNS coefficient peek (reference BfvCiphertext::get_coeff,
        fhe_lib_v2.h:1277)."""
        import numpy as np
        return int(np.asarray(ct.data)[poly_idx, limb, coeff_idx])

    def _rotate_unit(self, ct, step: int):
        elt = galois_elt_col(step, self.params.n)
        return self.engine.apply_galois(np, ct, elt, self._glk_for(elt))

    def rotate_rows(self, ct):
        elt = galois_elt_row(self.params.n)
        return self.engine.apply_galois(np, ct, elt, self._glk_for(elt))


class BfvContext(FheContext):
    engine_cls = BfvEngine

    def mult_scalar(self, ct, scalar: int):
        return self.engine.mult_scalar(np, ct, scalar)

    def encode_coeffs(self, coeffs, level=None):
        level = self.params.max_level if level is None else level
        return self.engine.encode_coeffs(coeffs, level)

    def encode_coeffs_ringt(self, coeffs):
        return self.engine.encode_coeffs_ringt(coeffs)

    def encode_coeffs_mul(self, coeffs, level=None):
        level = self.params.max_level if level is None else level
        return self.engine.encode_coeffs_mul(coeffs, level)

    def decrypt_coeffs(self, ct):
        if self.sk is None:
            raise RuntimeError('Context does not have sk and decryptor.')
        return self.engine.decrypt_coeffs(self.sk, ct)

    def noise_budget(self, ct) -> float:
        """Remaining invariant-noise budget of ``ct`` in bits (SEAL
        semantics: decryption is reliable while positive). Measurement
        aid for level/parameter planning; requires the secret key."""
        if self.sk is None:
            raise RuntimeError('noise_budget requires the secret key')
        return self.engine.noise_budget(self.sk, ct)


class CkksContext(FheContext):
    engine_cls = CkksEngine

    def _max_message_len(self) -> int:
        return self.params.slots

    def poly_eval_relu_function(self, ct, degree: int = 15, bound: float = 1.0):
        """Polynomial ReLU activation (reference poly_eval_relu_function,
        fhe_lib_v2.h:1101)."""
        from ..schemes.poly_eval import poly_eval_relu
        return poly_eval_relu(self.engine, np, ct, self.rlk, degree, bound)

    def poly_eval_step_function(self, ct, degree: int = 15, bound: float = 1.0):
        """Polynomial step activation (reference poly_eval_step_function)."""
        from ..schemes.poly_eval import poly_eval_step
        return poly_eval_step(self.engine, np, ct, self.rlk, degree, bound)

    def create_bootstrapper(self, config=None):
        """Build the bootstrap precompute and its Galois keys (reference:
        CkksBtpContext::create_bootstrapper, fhe_lib_v2.h:1216)."""
        from ..schemes.bootstrap import CkksBootstrapper
        btp = CkksBootstrapper(self.engine, config)
        self.gen_galois_keys_for_elements(btp.galois_elements())
        self.engine.bootstrapper = btp
        return btp

    def bootstrap(self, ct):
        if getattr(self.engine, 'bootstrapper', None) is None:
            raise RuntimeError('call create_bootstrapper() first')
        import numpy as np
        return self.engine.bootstrapper(np, ct, self.rlk, self.glk.keys)


class CkksBtpContext(CkksContext):
    """CKKS context with bootstrapping enabled at creation (reference
    CkksBtpContext, fhe_lib_v2.h:1173-1217). Two-secret design: a dense
    evaluation secret plus a sparse bootstrap secret (reference parameter
    sets: H192) bridged by swk_dts / swk_std switching keys."""

    @classmethod
    def create_random_context(cls, params, seed=None, h: int = 192,
                              btp_config=None):
        from ..schemes import keys as K
        ctx = cls(params, seed)
        q, p, n = tuple(params.q), tuple(params.p), params.n
        wb = params.word_bits
        ctx.sk = K.SecretKey(K.sample_ternary(ctx.rng, n))
        ctx.pk = K.gen_public_key(ctx.rng, ctx.sk, q, n, wb)
        ctx.rlk = K.gen_relin_key(ctx.rng, ctx.sk, q, p, n, wb)
        ctx.sk_sparse = K.SecretKey(K.sample_ternary(ctx.rng, n, h=min(h, n // 4)))
        # swk_dts re-keys dense→sparse (encrypts s_dense under s_sparse);
        # swk_std re-keys sparse→dense
        ctx.swk['swk_dts'] = K.gen_keyswitch_key(
            ctx.rng, ctx.sk_sparse,
            lambda mods: ctx.sk.ntt_form(tuple(mods), n, wb), q, p, n, wb)
        ctx.swk['swk_std'] = K.gen_keyswitch_key(
            ctx.rng, ctx.sk,
            lambda mods: ctx.sk_sparse.ntt_form(tuple(mods), n, wb), q, p, n,
            wb)
        ctx.create_bootstrapper(btp_config)
        return ctx

    def bootstrap(self, ct):
        import numpy as np
        btp = getattr(self.engine, 'bootstrapper', None)
        if btp is None:
            raise RuntimeError('call create_bootstrapper() first')
        return btp(np, ct, self.rlk, self.glk.keys,
                   swk_dts=self.swk.get('swk_dts'),
                   swk_std=self.swk.get('swk_std'))

    def conjugate(self, ct):
        return self.rotate_rows(ct)

    def drop_level(self, ct, levels=1):
        return self.engine.drop_level(np, ct, levels)

    def set_log_slots(self, log_slots: int):
        self.params.set_log_slots(log_slots)

    def mult_scalar(self, ct, scalar: float):
        return self.engine.mult_scalar(np, ct, scalar)


def create_context_for_params(params, seed=None, random=True):
    cls = BfvContext if isinstance(params, BfvParams) else CkksContext
    return cls.create_random_context(params, seed) if random else cls(params)
