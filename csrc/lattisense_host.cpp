// Host-side native crypto kernels (SDK band).
//
// The reference delegates all host crypto to Lattigo's Go kernels via cgo
// (SURVEY.md §2.5); here the device runs the compiled evaluation path and this
// library accelerates the *host* paths that stay on CPU: key generation,
// encode/encrypt/decrypt inside the SDK, and the NumPy golden model the
// conformance suite compares against. Exact u64 modular arithmetic via
// native 128-bit products — bit-identical to core/u64.py (the Python/XLA
// path), which the test suite asserts.
//
// C ABI only (loaded via ctypes, lattisense_tpu/native.py). Layouts match
// the framework's device arrays: polynomials are (L, n) row-major u64 with
// per-limb constant tables, so buffers move between NumPy and this library
// with zero copies.

#include <cstdint>
#include <cstring>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

extern "C" {

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

static inline u64 addmod(u64 a, u64 b, u64 q) {
    u64 s = a + b;
    return s >= q ? s - q : s;
}

static inline u64 submod(u64 a, u64 b, u64 q) {
    return a >= b ? a - b : a + q - b;
}

static inline u64 mulhi(u64 a, u64 b) {
    return (u64)(((u128)a * b) >> 64);
}

// Shoup multiplication by a precomputed constant: a*w mod q,
// w_shoup = floor(w<<64 / q).
static inline u64 shoup_mul(u64 a, u64 w, u64 w_shoup, u64 q) {
    u64 hi = mulhi(a, w_shoup);
    u64 r = a * w - hi * q;
    return r >= q ? r - q : r;
}

// Montgomery REDC (R = 2^64): (hi*2^64 + lo) * R^-1 mod q.
static inline u64 redc(u64 hi, u64 lo, u64 q, u64 qinv_neg) {
    u64 m = lo * qinv_neg;
    u64 t = hi + mulhi(m, q) + (lo != 0);
    return t >= q ? t - q : t;
}

static inline u64 mont_mul(u64 a, u64 b, u64 q, u64 qinv_neg) {
    u128 p = (u128)a * b;
    return redc((u64)(p >> 64), (u64)p, q, qinv_neg);
}

// ---------------------------------------------------------------------------
// vector mod ops over (L, n) limb stacks
// ---------------------------------------------------------------------------

void ls_vec_addmod(const u64* a, const u64* b, u64* out, const u64* q,
                   long L, long n) {
    for (long i = 0; i < L; ++i) {
        u64 qi = q[i];
        const u64* ai = a + i * n;
        const u64* bi = b + i * n;
        u64* oi = out + i * n;
        for (long j = 0; j < n; ++j) oi[j] = addmod(ai[j], bi[j], qi);
    }
}

void ls_vec_submod(const u64* a, const u64* b, u64* out, const u64* q,
                   long L, long n) {
    for (long i = 0; i < L; ++i) {
        u64 qi = q[i];
        const u64* ai = a + i * n;
        const u64* bi = b + i * n;
        u64* oi = out + i * n;
        for (long j = 0; j < n; ++j) oi[j] = submod(ai[j], bi[j], qi);
    }
}

void ls_vec_mont_mul(const u64* a, const u64* b, u64* out, const u64* q,
                     const u64* qinv_neg, long L, long n) {
    for (long i = 0; i < L; ++i) {
        u64 qi = q[i], mi = qinv_neg[i];
        const u64* ai = a + i * n;
        const u64* bi = b + i * n;
        u64* oi = out + i * n;
        for (long j = 0; j < n; ++j) oi[j] = mont_mul(ai[j], bi[j], qi, mi);
    }
}

void ls_vec_mulmod(const u64* a, const u64* b, u64* out, const u64* q,
                   const u64* qinv_neg, const u64* r2, long L, long n) {
    for (long i = 0; i < L; ++i) {
        u64 qi = q[i], mi = qinv_neg[i], r2i = r2[i];
        const u64* ai = a + i * n;
        const u64* bi = b + i * n;
        u64* oi = out + i * n;
        for (long j = 0; j < n; ++j)
            oi[j] = mont_mul(mont_mul(ai[j], bi[j], qi, mi), r2i, qi, mi);
    }
}

// ---------------------------------------------------------------------------
// negacyclic NTT / INTT (in place, batch over limbs)
//
// Identical butterfly order and tables as core/ntt.py: Cooley–Tukey forward
// (natural → bit-reversed) and Gentleman–Sande inverse with merged psi
// twiddles in bit-reversed table order (Longa–Naehrig).
// ---------------------------------------------------------------------------

void ls_ntt_forward(u64* data, const u64* psi_rev, const u64* psi_rev_shoup,
                    const u64* q, long L, long n) {
    for (long l = 0; l < L; ++l) {
        u64* x = data + l * n;
        const u64* tbl = psi_rev + l * n;
        const u64* tbl_sh = psi_rev_shoup + l * n;
        u64 qi = q[l];
        long t = n;
        for (long m = 1; m < n; m <<= 1) {
            t >>= 1;
            for (long k = 0; k < m; ++k) {
                u64 s = tbl[m + k];
                u64 s_sh = tbl_sh[m + k];
                u64* xa = x + 2 * k * t;
                u64* xb = xa + t;
                for (long j = 0; j < t; ++j) {
                    u64 u = xa[j];
                    u64 v = shoup_mul(xb[j], s, s_sh, qi);
                    xa[j] = addmod(u, v, qi);
                    xb[j] = submod(u, v, qi);
                }
            }
        }
    }
}

void ls_ntt_inverse(u64* data, const u64* psi_inv_rev,
                    const u64* psi_inv_rev_shoup, const u64* n_inv,
                    const u64* n_inv_shoup, const u64* q, long L, long n) {
    for (long l = 0; l < L; ++l) {
        u64* x = data + l * n;
        const u64* tbl = psi_inv_rev + l * n;
        const u64* tbl_sh = psi_inv_rev_shoup + l * n;
        u64 qi = q[l];
        long t = 1;
        for (long m = n >> 1; m >= 1; m >>= 1) {
            for (long k = 0; k < m; ++k) {
                u64 s = tbl[m + k];
                u64 s_sh = tbl_sh[m + k];
                u64* xa = x + 2 * k * t;
                u64* xb = xa + t;
                for (long j = 0; j < t; ++j) {
                    u64 u = xa[j];
                    u64 v = xb[j];
                    xa[j] = addmod(u, v, qi);
                    xb[j] = shoup_mul(submod(u, v, qi), s, s_sh, qi);
                }
            }
            t <<= 1;
        }
        u64 ni = n_inv[l], ni_sh = n_inv_shoup[l];
        for (long j = 0; j < n; ++j) x[j] = shoup_mul(x[j], ni, ni_sh, qi);
    }
}

// ---------------------------------------------------------------------------
// raw RNS ABI exchange (plug-in band, reference abi/c_types.h layout):
// contiguous per-component u64 buffers <-> (degree+1, L, n) stacks.
// The canonical struct layout is length-prefixed components; here the
// Python side passes explicit dims so the copy is a memcpy per poly.
// ---------------------------------------------------------------------------

void ls_export_poly(const u64* src, u64* dst, long count) {
    std::memcpy(dst, src, (size_t)count * sizeof(u64));
}

int ls_abi_version(void) { return 1; }

}  // extern "C"
