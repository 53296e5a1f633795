/* Native host-side BN254 arithmetic for the orchestration layer.
 *
 * The card owns the O(n log n) / O(n * windows) kernels (NTT, MSM, quotient);
 * this library owns the host-resident sequential/hot loops that the reference
 * implements in native Rust (uzkge/src/plonk/helpers.rs): the z permutation
 * grand product, linearization-polynomial combination, Horner evaluations
 * and the opening division, over Fr; and the commits' blinding, a few G1
 * scalar multiples added to a commitment (kzg_poly_commitment.rs:299-313),
 * over Fq.  Called from python via ctypes (see native_host.py); scalars and
 * coordinates cross the boundary as 32-byte little-endian blobs.
 *
 * Arithmetic: 4x64-bit limbs, CIOS Montgomery multiplication with unsigned
 * __int128 accumulators, Fermat inversion.  No function keeps state between
 * calls: the threads of parallel/batch.py call in at once.
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

typedef struct { u64 v[4]; } fe;

/* A prime field below 2^255 (little-endian limbs). */
typedef struct {
    u64 m[4];   /* the modulus */
    u64 n0;     /* -m^-1 mod 2^64 */
    fe r2;      /* R^2 mod m (R = 2^256) */
    fe one;     /* R mod m: one in Montgomery form */
    u64 e[4];   /* m - 2: Fermat's exponent */
} field;

/* BN254 Fr, the scalar field */
static const field FR = {
    {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
     0xb85045b68181585dULL, 0x30644e72e131a029ULL},
    0xc2e1f593efffffffULL,
    {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
      0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL}},
    {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
      0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL}},
    {0x43e1f593efffffffULL, 0x2833e84879b97091ULL,
     0xb85045b68181585dULL, 0x30644e72e131a029ULL},
};

/* BN254 Fq, the field of G1's coordinates */
static const field FQ = {
    {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
     0xb85045b68181585dULL, 0x30644e72e131a029ULL},
    0x87d20782e4866389ULL,
    {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
      0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}},
    {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
      0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}},
    {0x3c208c16d87cfd45ULL, 0x97816a916871ca8dULL,
     0xb85045b68181585dULL, 0x30644e72e131a029ULL},
};

/* inlined into each field's wrappers below, so that the modulus is a
 * constant there */
#define FIELD_OP static inline __attribute__((always_inline))

FIELD_OP int geq_m(const u64 a[4], const u64 m[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > m[i]) return 1;
        if (a[i] < m[i]) return 0;
    }
    return 1;
}

FIELD_OP void sub_m(u64 a[4], const u64 m[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - m[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

FIELD_OP void f_add(fe *out, const fe *a, const fe *b, const field *F) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a->v[i] + b->v[i];
        out->v[i] = (u64)c;
        c >>= 64;
    }
    if (c || geq_m(out->v, F->m)) sub_m(out->v, F->m);
}

FIELD_OP void f_sub(fe *out, const fe *a, const fe *b, const field *F) {
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
            c += (u128)t[i] + F->m[i];
            t[i] = (u64)c;
            c >>= 64;
        }
    }
    memcpy(out->v, t, 32);
}

/* CIOS Montgomery multiplication: out = a*b*R^-1 mod m */
FIELD_OP void f_mul(fe *out, const fe *a, const fe *b, const field *F) {
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

        u64 m = t[0] * F->n0;
        c = (u128)t[0] + (u128)m * F->m[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * F->m[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    memcpy(out->v, t, 32);
    if (t[4] || geq_m(out->v, F->m)) sub_m(out->v, F->m);
}

/* Fermat inverse: a^(m-2), a in Montgomery form */
FIELD_OP void f_inv(fe *out, const fe *a, const field *F) {
    fe result = F->one;
    fe base = *a;
    for (int limb = 0; limb < 4; limb++) {
        u64 e = F->e[limb];
        for (int i = 0; i < 64; i++) {
            if ((e >> i) & 1) f_mul(&result, &result, &base, F);
            f_mul(&base, &base, &base, F);
        }
    }
    *out = result;
}

static const fe STD_ONE = {{1, 0, 0, 0}};

static void fr_add(fe *out, const fe *a, const fe *b) { f_add(out, a, b, &FR); }
static void fr_sub(fe *out, const fe *a, const fe *b) { f_sub(out, a, b, &FR); }
static void fr_mul(fe *out, const fe *a, const fe *b) { f_mul(out, a, b, &FR); }
static void fr_to_mont(fe *out, const fe *a) { f_mul(out, a, &FR.r2, &FR); }
static void fr_from_mont(fe *out, const fe *a) { f_mul(out, a, &STD_ONE, &FR); }
static void fr_inv(fe *out, const fe *a) { f_inv(out, a, &FR); }

static void fq_add(fe *out, const fe *a, const fe *b) { f_add(out, a, b, &FQ); }
static void fq_sub(fe *out, const fe *a, const fe *b) { f_sub(out, a, b, &FQ); }
static void fq_mul(fe *out, const fe *a, const fe *b) { f_mul(out, a, b, &FQ); }
static void fq_to_mont(fe *out, const fe *a) { f_mul(out, a, &FQ.r2, &FQ); }
static void fq_from_mont(fe *out, const fe *a) { f_mul(out, a, &STD_ONE, &FQ); }
static void fq_inv(fe *out, const fe *a) { f_inv(out, a, &FQ); }

/* ------------------------------------------------------------------ API --
 * All buffers are arrays of 32-byte little-endian standard-form scalars
 * unless stated otherwise. */

static inline void load(fe *x, const unsigned char *buf) {
    memcpy(x->v, buf, 32);
}

static inline void store(unsigned char *buf, const fe *x) {
    memcpy(buf, x->v, 32);
}

/* out = p(x) for a dense polynomial with n coefficients */
void horner_eval(const unsigned char *coefs, u64 n, const unsigned char *x,
                 unsigned char *out) {
    fe xm, acc = {{0, 0, 0, 0}}, c;
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
    fe km[5], betam, gammam;
    for (int j = 0; j < 5; j++) {
        load(&km[j], k + j * 32);
        fr_to_mont(&km[j], &km[j]);
    }
    load(&betam, beta);
    fr_to_mont(&betam, &betam);
    load(&gammam, gamma);
    fr_to_mont(&gammam, &gammam);

    /* group in mont, cached */
    fe *gm = (fe *)__builtin_malloc(sizeof(fe) * n);
    for (u64 i = 0; i < n; i++) {
        load(&gm[i], group + i * 32);
        fr_to_mont(&gm[i], &gm[i]);
    }
    fe *nums = (fe *)__builtin_malloc(sizeof(fe) * (n - 1));
    fe *dens = (fe *)__builtin_malloc(sizeof(fe) * (n - 1));

    for (u64 i = 0; i + 1 < n; i++) {
        fe num = {{0}}, den = {{0}};
        num = FR.one;
        den = FR.one;
        for (int j = 0; j < 5; j++) {
            fe f, tmp, idv, pv;
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
        fe *pref = (fe *)__builtin_malloc(sizeof(fe) * (n - 1));
        pref[0] = dens[0];
        for (u64 i = 1; i + 1 < n; i++) fr_mul(&pref[i], &pref[i - 1], &dens[i]);
        fe inv;
        fr_inv(&inv, &pref[n - 2]);
        for (u64 i = n - 1; i > 1; i--) {
            fe tmp;
            fr_mul(&tmp, &inv, &pref[i - 2]);
            fr_mul(&inv, &inv, &dens[i - 1]);
            dens[i - 1] = tmp;
        }
        dens[0] = inv;
        __builtin_free(pref);
    }

    fe prev;
    prev = FR.one;
    fe z0;
    fr_from_mont(&z0, &prev);
    store(out, &z0);
    for (u64 i = 0; i + 1 < n; i++) {
        fe ratio;
        fr_mul(&ratio, &nums[i], &dens[i]);
        fr_mul(&prev, &prev, &ratio);
        fe zo;
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
    fe *acc = (fe *)__builtin_malloc(sizeof(fe) * out_len);
    memset(acc, 0, sizeof(fe) * out_len);
    const unsigned char *rp = rows_buf;
    for (u64 r = 0; r < n_rows; r++) {
        fe s;
        load(&s, scalars + r * 32);
        int zero = 1;
        for (int i = 0; i < 4; i++) zero &= (s.v[i] == 0);
        if (!zero) {
            fe sm;
            fr_to_mont(&sm, &s);
            for (u64 i = 0; i < row_lens[r]; i++) {
                fe c, t;
                load(&c, rp + i * 32);
                fr_to_mont(&c, &c);
                fr_mul(&t, &c, &sm);
                fr_add(&acc[i], &acc[i], &t);
            }
        }
        rp += row_lens[r] * 32;
    }
    for (u64 i = 0; i < out_len; i++) {
        fe o;
        fr_from_mont(&o, &acc[i]);
        store(out + i * 32, &o);
    }
    __builtin_free(acc);
}

/* q(X) = (h(X) - h(z)) / (X - z); in: n coefs; out: n-1 coefs + remainder
 * check is caller's job (returns h(z) via out_rem) */
void synthetic_div(const unsigned char *coefs, u64 n, const unsigned char *z,
                   unsigned char *out, unsigned char *out_rem) {
    fe zm, acc = {{0, 0, 0, 0}};
    load(&zm, z);
    fr_to_mont(&zm, &zm);
    for (u64 i = n - 1; i > 0; i--) {
        fe c;
        load(&c, coefs + i * 32);
        fr_to_mont(&c, &c);
        fr_mul(&acc, &acc, &zm);
        fr_add(&acc, &acc, &c);
        fe o;
        fr_from_mont(&o, &acc);
        store(out + (i - 1) * 32, &o);
    }
    fe c, rem;
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
    fe am, pm, mult;
    load(&am, alpha);
    fr_to_mont(&am, &am);
    load(&pm, point);
    fr_to_mont(&pm, &pm);
    mult = FR.one;

    fe *acc = (fe *)__builtin_malloc(sizeof(fe) * out_len);
    memset(acc, 0, sizeof(fe) * out_len);
    const unsigned char *rp = rows_buf;
    for (u64 r = 0; r < n_rows; r++) {
        u64 len = row_lens[r];
        /* eval p_r at point (Horner over mont) */
        fe ev = {{0, 0, 0, 0}};
        for (u64 i = len; i > 0; i--) {
            fe c;
            load(&c, rp + (i - 1) * 32);
            fr_to_mont(&c, &c);
            fr_mul(&ev, &ev, &pm);
            fr_add(&ev, &ev, &c);
        }
        fe evo;
        fr_from_mont(&evo, &ev);
        store(out_evals + r * 32, &evo);
        /* acc += mult * p_r; acc[0] -= mult * ev */
        for (u64 i = 0; i < len; i++) {
            fe c, t;
            load(&c, rp + i * 32);
            fr_to_mont(&c, &c);
            fr_mul(&t, &c, &mult);
            fr_add(&acc[i], &acc[i], &t);
        }
        fe t;
        fr_mul(&t, &ev, &mult);
        fr_sub(&acc[0], &acc[0], &t);
        fr_mul(&mult, &mult, &am);
        rp += len * 32;
    }
    for (u64 i = 0; i < out_len; i++) {
        fe o;
        fr_from_mont(&o, &acc[i]);
        store(out + i * 32, &o);
    }
    __builtin_free(acc);
}

/* ---------------------------------------------------------- G1 over Fq --
 * y^2 = x^3 + 3.  A Jacobian point (X, Y, Z), coordinates in Montgomery
 * form, stands for the affine (X / Z^2, Y / Z^3); Z = 0 is the identity.
 * G1 has prime order r and no point with y = 0. */

typedef struct { fe x, y, z; } g1j;

static int fe_is_zero(const fe *a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

/* r = 2p (dbl-2009-l, a = 0); r may be p.  The identity doubles to itself
 * (Z3 = 2 Y Z = 0). */
static void g1_dbl(g1j *r, const g1j *p) {
    fe a, b, c, d, e, f, t, z3;
    fq_mul(&a, &p->x, &p->x);
    fq_mul(&b, &p->y, &p->y);
    fq_mul(&c, &b, &b);
    fq_add(&t, &p->x, &b);
    fq_mul(&t, &t, &t);
    fq_sub(&t, &t, &a);
    fq_sub(&t, &t, &c);
    fq_add(&d, &t, &t);             /* D = 2 ((X + B)^2 - A - C) */
    fq_add(&e, &a, &a);
    fq_add(&e, &e, &a);             /* E = 3 A */
    fq_mul(&f, &e, &e);
    fq_mul(&z3, &p->y, &p->z);
    fq_add(&z3, &z3, &z3);          /* Z3 = 2 Y Z */
    fq_sub(&r->x, &f, &d);
    fq_sub(&r->x, &r->x, &d);       /* X3 = F - 2 D */
    fq_sub(&t, &d, &r->x);
    fq_mul(&t, &e, &t);
    fq_add(&c, &c, &c);
    fq_add(&c, &c, &c);
    fq_add(&c, &c, &c);
    fq_sub(&r->y, &t, &c);          /* Y3 = E (D - X3) - 8 C */
    r->z = z3;
}

/* r = p + (qx, qy), the second point affine and not the identity
 * (madd-2007-bl, Z3 = 2 Z1 H); r may be p.  Complete: p the identity, q = p
 * (a doubling) and q = -p (the identity) each take their own branch. */
static void g1_madd(g1j *r, const g1j *p, const fe *qx, const fe *qy) {
    if (fe_is_zero(&p->z)) {
        r->x = *qx;
        r->y = *qy;
        r->z = FQ.one;
        return;
    }
    fe z1z1, u2, s2, h, rr, hh, i, j, v, yj, z3, t;
    fq_mul(&z1z1, &p->z, &p->z);
    fq_mul(&u2, qx, &z1z1);
    fq_mul(&s2, qy, &p->z);
    fq_mul(&s2, &s2, &z1z1);
    fq_sub(&h, &u2, &p->x);
    fq_sub(&rr, &s2, &p->y);
    if (fe_is_zero(&h)) {           /* same x: q = p or q = -p */
        if (fe_is_zero(&rr))
            g1_dbl(r, p);
        else
            memset(r, 0, sizeof *r);
        return;
    }
    fq_mul(&hh, &h, &h);
    fq_add(&i, &hh, &hh);
    fq_add(&i, &i, &i);             /* I = 4 H^2 */
    fq_mul(&j, &h, &i);             /* J = H I */
    fq_add(&rr, &rr, &rr);          /* r = 2 (S2 - Y1) */
    fq_mul(&v, &p->x, &i);          /* V = X1 I */
    fq_mul(&yj, &p->y, &j);
    fq_add(&yj, &yj, &yj);          /* 2 Y1 J */
    fq_mul(&z3, &p->z, &h);
    fq_add(&z3, &z3, &z3);          /* Z3 = 2 Z1 H */
    fq_mul(&t, &rr, &rr);
    fq_sub(&t, &t, &j);
    fq_sub(&t, &t, &v);
    fq_sub(&r->x, &t, &v);          /* X3 = r^2 - J - 2 V */
    fq_sub(&t, &v, &r->x);
    fq_mul(&t, &rr, &t);
    fq_sub(&r->y, &t, &yj);         /* Y3 = r (V - X3) - 2 Y1 J */
    r->z = z3;
}

/* out = cm + sum_i s_i P_i, the commits' blinding (kzg:299-313, each blind
 * b a pair of terms b G_i and -b G_{zeroing+i}).  Points are affine, 64
 * bytes each (x then y, 32-byte little-endian standard form); `points`
 * holds k of them, none the identity, and `scalars` k 32-byte little-endian
 * integers below 2^256; cm is the identity where cm_inf is nonzero.  One
 * doubling chain over all the scalars' bits, most significant first, a
 * complete mixed addition for each set bit, cm added last, and one
 * inversion for the affine result.  Returns 1, out zeroed, where the sum
 * is the identity, else 0 with the affine sum in out (64 bytes). */
int g1_blind(const unsigned char *cm, int cm_inf, const unsigned char *points,
             const unsigned char *scalars, u64 k, unsigned char *out) {
    fe *pts = (fe *)__builtin_malloc(sizeof(fe) * 2 * (k ? k : 1));
    for (u64 i = 0; i < 2 * k; i++) {
        load(&pts[i], points + i * 32);
        fq_to_mont(&pts[i], &pts[i]);
    }
    g1j acc;
    memset(&acc, 0, sizeof acc);
    for (int bit = 255; bit >= 0; bit--) {
        if (!fe_is_zero(&acc.z)) g1_dbl(&acc, &acc);
        for (u64 i = 0; i < k; i++)
            if ((scalars[i * 32 + bit / 8] >> (bit % 8)) & 1)
                g1_madd(&acc, &acc, &pts[2 * i], &pts[2 * i + 1]);
    }
    __builtin_free(pts);
    if (!cm_inf) {
        fe cx, cy;
        load(&cx, cm);
        load(&cy, cm + 32);
        fq_to_mont(&cx, &cx);
        fq_to_mont(&cy, &cy);
        g1_madd(&acc, &acc, &cx, &cy);
    }
    if (fe_is_zero(&acc.z)) {
        memset(out, 0, 64);
        return 1;
    }
    fe zi, zi2, x, y;
    fq_inv(&zi, &acc.z);
    fq_mul(&zi2, &zi, &zi);
    fq_mul(&x, &acc.x, &zi2);
    fq_mul(&y, &acc.y, &zi2);
    fq_mul(&y, &y, &zi);
    fq_from_mont(&x, &x);
    fq_from_mont(&y, &y);
    store(out, &x);
    store(out + 32, &y);
    return 0;
}
