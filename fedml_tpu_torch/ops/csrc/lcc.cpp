// Lagrange-coded-computing kernels for SecAgg/LightSecAgg, on the host.
//
// The port's own copy of the reference's native/lcc.cpp (finite-field
// Lagrange coefficients, modular inverse, the encode/decode "matmul"); the
// numpy twin lives in fedml_tpu_torch/core/mpc/lcc.py and the tests hold
// the two against each other bit for bit.
//
// Build: fedml_tpu_torch/ops/_build.py (build_host) compiles it with the
// host C++ compiler into build/fedml_tpu_torch/ at first use.
// Bind:  ctypes (fedml_tpu_torch/core/mpc/lcc.py).
//
// All arithmetic is mod a prime p < 2^31, so products fit in 64 bits and
// sums of products are reduced incrementally.

#include <cstdint>
#include <cstddef>

extern "C" {

static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t p) {
#ifdef __SIZEOF_INT128__
    return (uint64_t)(((__uint128_t)a * b) % p);
#else
    return (a * b) % p;  // safe for p < 2^31
#endif
}

static inline uint64_t powmod(uint64_t a, uint64_t e, uint64_t p) {
    uint64_t r = 1 % p;
    a %= p;
    while (e) {
        if (e & 1) r = mulmod(r, a, p);
        a = mulmod(a, a, p);
        e >>= 1;
    }
    return r;
}

// Fermat inverse (p prime).
uint64_t lcc_modinv(uint64_t a, uint64_t p) { return powmod(a % p, p - 2, p); }

// Lagrange coefficient matrix U[n_target x n_eval]:
//   U[i][j] = prod_{l != j} (target_i - eval_l) / (eval_j - eval_l)   (mod p)
// eval points must be pairwise distinct mod p.
// Returns 0 on success, -1 if a zero denominator is hit.
int lcc_lagrange_coeffs(const int64_t* eval_pts, int64_t n_eval,
                        const int64_t* target_pts, int64_t n_target,
                        int64_t p_, int64_t* out /* n_target*n_eval */) {
    const uint64_t p = (uint64_t)p_;
    for (int64_t i = 0; i < n_target; ++i) {
        const uint64_t t = (uint64_t)(((target_pts[i] % p_) + p_) % p_);
        for (int64_t j = 0; j < n_eval; ++j) {
            uint64_t num = 1, den = 1;
            const uint64_t ej = (uint64_t)(((eval_pts[j] % p_) + p_) % p_);
            for (int64_t l = 0; l < n_eval; ++l) {
                if (l == j) continue;
                const uint64_t el = (uint64_t)(((eval_pts[l] % p_) + p_) % p_);
                num = mulmod(num, (t + p - el) % p, p);
                den = mulmod(den, (ej + p - el) % p, p);
            }
            if (den == 0) return -1;
            out[i * n_eval + j] = (int64_t)mulmod(num, lcc_modinv(den, p), p);
        }
    }
    return 0;
}

// Field "matmul": out[n_out x dim] = coeffs[n_out x n_in] * X[n_in x dim] mod p.
// This is both LCC encode (X = data+noise rows, coeffs from beta->alpha) and
// decode (X = surviving evaluations, coeffs from alpha->beta).
void lcc_field_matmul(const int64_t* coeffs, const int64_t* X,
                      int64_t n_out, int64_t n_in, int64_t dim,
                      int64_t p_, int64_t* out) {
    const uint64_t p = (uint64_t)p_;
    for (int64_t i = 0; i < n_out; ++i) {
        for (int64_t d = 0; d < dim; ++d) out[i * dim + d] = 0;
        for (int64_t j = 0; j < n_in; ++j) {
            const uint64_t c = (uint64_t)(((coeffs[i * n_in + j] % p_) + p_) % p_);
            if (c == 0) continue;
            const int64_t* xrow = X + j * dim;
            int64_t* orow = out + i * dim;
            for (int64_t d = 0; d < dim; ++d) {
                const uint64_t x = (uint64_t)(((xrow[d] % p_) + p_) % p_);
                orow[d] = (int64_t)(((uint64_t)orow[d] + mulmod(c, x, p)) % p);
            }
        }
    }
}

}  // extern "C"
