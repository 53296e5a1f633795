/* Native host-side BN254 Fr arithmetic for the orchestration layer.
 *
 * The card owns the O(n log n) / O(n * windows) kernels (NTT, MSM, quotient);
 * this library owns the host-resident sequential/hot loops that the reference
 * implements in native Rust (uzkge/src/plonk/helpers.rs): the z permutation
 * grand product, linearization-polynomial combination, Horner evaluations
 * and the opening division.  Called from python via ctypes
 * (see native_host.py); scalars cross the boundary as 32-byte
 * little-endian blobs.
 *
 * Arithmetic: 4x64-bit limbs, CIOS Montgomery multiplication with unsigned
 * __int128 accumulators, Fermat inversion.
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* BN254 Fr modulus (little-endian limbs) */
static const u64 P[4] = {
    0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
    0xb85045b68181585dULL, 0x30644e72e131a029ULL,
};
/* -p^-1 mod 2^64 */
static const u64 N0INV = 0xc2e1f593efffffffULL;
/* R^2 mod p (R = 2^256) */
static const u64 R2[4] = {
    0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
    0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL,
};
/* R mod p (Montgomery one) */
static const u64 RMOD[4] = {
    0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
    0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL,
};

typedef struct { u64 v[4]; } fr;

static inline int geq_p(const u64 a[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > P[i]) return 1;
        if (a[i] < P[i]) return 0;
    }
    return 1;
}

static inline void sub_p(u64 a[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - P[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static void fr_add(fr *out, const fr *a, const fr *b) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a->v[i] + b->v[i];
        out->v[i] = (u64)c;
        c >>= 64;
    }
    if (c || geq_p(out->v)) sub_p(out->v);
}

static void fr_sub(fr *out, const fr *a, const fr *b) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 c = 0;
        for (int i = 0; i < 4; i++) {
            c += (u128)t[i] + P[i];
            t[i] = (u64)c;
            c >>= 64;
        }
    }
    memcpy(out->v, t, 32);
}

/* CIOS Montgomery multiplication: out = a*b*R^-1 mod p */
static void fr_mul(fr *out, const fr *a, const fr *b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        u64 bi = b->v[i];
        for (int j = 0; j < 4; j++) {
            c += (u128)t[j] + (u128)a->v[j] * bi;
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (u64)c;
        t[5] = (u64)(c >> 64);

        u64 m = t[0] * N0INV;
        c = (u128)t[0] + (u128)m * P[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * P[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    memcpy(out->v, t, 32);
    if (t[4] || geq_p(out->v)) sub_p(out->v);
}

static void fr_to_mont(fr *out, const fr *a) {
    fr r2;
    memcpy(r2.v, R2, 32);
    fr_mul(out, a, &r2);
}

static void fr_from_mont(fr *out, const fr *a) {
    fr one = {{1, 0, 0, 0}};
    fr_mul(out, a, &one);
}

/* Fermat inverse: a^(p-2), a in Montgomery form */
static void fr_inv(fr *out, const fr *a) {
    /* p-2 */
    static const u64 E[4] = {
        0x43e1f593efffffffULL, 0x2833e84879b97091ULL,
        0xb85045b68181585dULL, 0x30644e72e131a029ULL,
    };
    fr result;
    memcpy(result.v, RMOD, 32); /* one in Montgomery form */
    fr base = *a;
    for (int limb = 0; limb < 4; limb++) {
        u64 e = E[limb];
        int bits = 64;
        for (int i = 0; i < bits; i++) {
            if ((e >> i) & 1) fr_mul(&result, &result, &base);
            fr_mul(&base, &base, &base);
        }
    }
    *out = result;
}

/* ------------------------------------------------------------------ API --
 * All buffers are arrays of 32-byte little-endian standard-form scalars
 * unless stated otherwise. */

static inline void load(fr *x, const unsigned char *buf) {
    memcpy(x->v, buf, 32);
}

static inline void store(unsigned char *buf, const fr *x) {
    memcpy(buf, x->v, 32);
}

/* out = p(x) for a dense polynomial with n coefficients */
void horner_eval(const unsigned char *coefs, u64 n, const unsigned char *x,
                 unsigned char *out) {
    fr xm, acc = {{0, 0, 0, 0}}, c;
    load(&xm, x);
    fr_to_mont(&xm, &xm);
    for (u64 i = n; i > 0; i--) {
        /* acc = acc * x + coef (coef in standard form: mul acc_mont by x_mont
         * keeps acc in mont; add standard coef converted on the fly) */
        fr_mul(&acc, &acc, &xm);
        load(&c, coefs + (i - 1) * 32);
        fr_to_mont(&c, &c);
        fr_add(&acc, &acc, &c);
    }
    fr_from_mont(&acc, &acc);
    store(out, &acc);
}

/* z grand product (helpers.rs:160-220):
 *   witness: 5*n scalars (wire-major), perm: 5*n u64, group: n scalars,
 *   k: 5 scalars, out: n scalars (z evaluations) */
void z_poly(const unsigned char *witness, const u64 *perm,
            const unsigned char *group, const unsigned char *k,
            const unsigned char *beta, const unsigned char *gamma,
            u64 n, unsigned char *out) {
    fr km[5], betam, gammam;
    for (int j = 0; j < 5; j++) {
        load(&km[j], k + j * 32);
        fr_to_mont(&km[j], &km[j]);
    }
    load(&betam, beta);
    fr_to_mont(&betam, &betam);
    load(&gammam, gamma);
    fr_to_mont(&gammam, &gammam);

    /* group in mont, cached */
    fr *gm = (fr *)__builtin_malloc(sizeof(fr) * n);
    for (u64 i = 0; i < n; i++) {
        load(&gm[i], group + i * 32);
        fr_to_mont(&gm[i], &gm[i]);
    }
    fr *nums = (fr *)__builtin_malloc(sizeof(fr) * (n - 1));
    fr *dens = (fr *)__builtin_malloc(sizeof(fr) * (n - 1));

    for (u64 i = 0; i + 1 < n; i++) {
        fr num = {{0}}, den = {{0}};
        memcpy(num.v, RMOD, 32);
        memcpy(den.v, RMOD, 32);
        for (int j = 0; j < 5; j++) {
            fr f, tmp, idv, pv;
            load(&f, witness + (j * n + i) * 32);
            fr_to_mont(&f, &f);
            /* numerator factor: f + beta*k_j*g_i + gamma */
            fr_mul(&tmp, &km[j], &gm[i]);
            fr_mul(&tmp, &tmp, &betam);
            fr_add(&idv, &f, &tmp);
            fr_add(&idv, &idv, &gammam);
            fr_mul(&num, &num, &idv);
            /* denominator factor: f + beta*k_{p/n}*g_{p%n} + gamma */
            u64 pvraw = perm[j * n + i];
            fr_mul(&tmp, &km[pvraw / n], &gm[pvraw % n]);
            fr_mul(&tmp, &tmp, &betam);
            fr_add(&pv, &f, &tmp);
            fr_add(&pv, &pv, &gammam);
            fr_mul(&den, &den, &pv);
        }
        nums[i] = num;
        dens[i] = den;
    }

    /* batch invert dens (Montgomery trick, all in mont domain) */
    if (n > 1) {
        fr *pref = (fr *)__builtin_malloc(sizeof(fr) * (n - 1));
        pref[0] = dens[0];
        for (u64 i = 1; i + 1 < n; i++) fr_mul(&pref[i], &pref[i - 1], &dens[i]);
        fr inv;
        fr_inv(&inv, &pref[n - 2]);
        for (u64 i = n - 1; i > 1; i--) {
            fr tmp;
            fr_mul(&tmp, &inv, &pref[i - 2]);
            fr_mul(&inv, &inv, &dens[i - 1]);
            dens[i - 1] = tmp;
        }
        dens[0] = inv;
        __builtin_free(pref);
    }

    fr prev;
    memcpy(prev.v, RMOD, 32);
    fr z0;
    fr_from_mont(&z0, &prev);
    store(out, &z0);
    for (u64 i = 0; i + 1 < n; i++) {
        fr ratio;
        fr_mul(&ratio, &nums[i], &dens[i]);
        fr_mul(&prev, &prev, &ratio);
        fr zo;
        fr_from_mont(&zo, &prev);
        store(out + (i + 1) * 32, &zo);
    }
    __builtin_free(gm);
    __builtin_free(nums);
    __builtin_free(dens);
}

/* out += scalar * row for each (row, scalar); rows are column-major
 * contiguous: rows_buf holds R rows of len scalars each. */
void lincomb(const unsigned char *rows_buf, const u64 *row_lens,
             const unsigned char *scalars, u64 n_rows, u64 out_len,
             unsigned char *out) {
    fr *acc = (fr *)__builtin_malloc(sizeof(fr) * out_len);
    memset(acc, 0, sizeof(fr) * out_len);
    const unsigned char *rp = rows_buf;
    for (u64 r = 0; r < n_rows; r++) {
        fr s;
        load(&s, scalars + r * 32);
        int zero = 1;
        for (int i = 0; i < 4; i++) zero &= (s.v[i] == 0);
        if (!zero) {
            fr sm;
            fr_to_mont(&sm, &s);
            for (u64 i = 0; i < row_lens[r]; i++) {
                fr c, t;
                load(&c, rp + i * 32);
                fr_to_mont(&c, &c);
                fr_mul(&t, &c, &sm);
                fr_add(&acc[i], &acc[i], &t);
            }
        }
        rp += row_lens[r] * 32;
    }
    for (u64 i = 0; i < out_len; i++) {
        fr o;
        fr_from_mont(&o, &acc[i]);
        store(out + i * 32, &o);
    }
    __builtin_free(acc);
}

/* q(X) = (h(X) - h(z)) / (X - z); in: n coefs; out: n-1 coefs + remainder
 * check is caller's job (returns h(z) via out_rem) */
void synthetic_div(const unsigned char *coefs, u64 n, const unsigned char *z,
                   unsigned char *out, unsigned char *out_rem) {
    fr zm, acc = {{0, 0, 0, 0}};
    load(&zm, z);
    fr_to_mont(&zm, &zm);
    for (u64 i = n - 1; i > 0; i--) {
        fr c;
        load(&c, coefs + i * 32);
        fr_to_mont(&c, &c);
        fr_mul(&acc, &acc, &zm);
        fr_add(&acc, &acc, &c);
        fr o;
        fr_from_mont(&o, &acc);
        store(out + (i - 1) * 32, &o);
    }
    fr c, rem;
    load(&c, coefs);
    fr_to_mont(&c, &c);
    fr_mul(&acc, &acc, &zm);
    fr_add(&rem, &acc, &c);
    fr_from_mont(&rem, &rem);
    store(out_rem, &rem);
}

/* alpha-combination of polynomials for batch openings:
 * h = sum_i alpha^i * (p_i - p_i(point)) — evaluations returned too. */
void alpha_combine(const unsigned char *rows_buf, const u64 *row_lens,
                   u64 n_rows, const unsigned char *alpha,
                   const unsigned char *point, u64 out_len,
                   unsigned char *out, unsigned char *out_evals) {
    fr am, pm, mult;
    load(&am, alpha);
    fr_to_mont(&am, &am);
    load(&pm, point);
    fr_to_mont(&pm, &pm);
    memcpy(mult.v, RMOD, 32);

    fr *acc = (fr *)__builtin_malloc(sizeof(fr) * out_len);
    memset(acc, 0, sizeof(fr) * out_len);
    const unsigned char *rp = rows_buf;
    for (u64 r = 0; r < n_rows; r++) {
        u64 len = row_lens[r];
        /* eval p_r at point (Horner over mont) */
        fr ev = {{0, 0, 0, 0}};
        for (u64 i = len; i > 0; i--) {
            fr c;
            load(&c, rp + (i - 1) * 32);
            fr_to_mont(&c, &c);
            fr_mul(&ev, &ev, &pm);
            fr_add(&ev, &ev, &c);
        }
        fr evo;
        fr_from_mont(&evo, &ev);
        store(out_evals + r * 32, &evo);
        /* acc += mult * p_r; acc[0] -= mult * ev */
        for (u64 i = 0; i < len; i++) {
            fr c, t;
            load(&c, rp + i * 32);
            fr_to_mont(&c, &c);
            fr_mul(&t, &c, &mult);
            fr_add(&acc[i], &acc[i], &t);
        }
        fr t;
        fr_mul(&t, &ev, &mult);
        fr_sub(&acc[0], &acc[0], &t);
        fr_mul(&mult, &mult, &am);
        rp += len * 32;
    }
    for (u64 i = 0; i < out_len; i++) {
        fr o;
        fr_from_mont(&o, &acc[i]);
        store(out + i * 32, &o);
    }
    __builtin_free(acc);
}
