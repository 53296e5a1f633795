"""BN254 (alt_bn128) and BabyJubjub curve constants.

These are standard, publicly documented curve parameters (EIP-196/197 and the
Baby Jubjub specification), matching the reference implementation's arkworks
crates (`ark-bn254-zypher`, `ark-ed-on-bn254-zypher`; see
the reference's Cargo.toml:33-34).

Everything transcript-visible in the proving system depends on these values
being exact.
"""

# ---------------------------------------------------------------------------
# BN254 scalar field Fr and base field Fq
# ---------------------------------------------------------------------------

# |G1| = |G2| = r  (the SNARK scalar field)
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# Base field modulus q (coordinates of G1 live in Fq)
Q_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Multiplicative generator and 2-adicity of Fr (matches ark-bn254 FrConfig:
# GENERATOR = 5, TWO_ADICITY = 28).  Used to derive radix-2 evaluation-domain
# roots of unity exactly as `Radix2EvaluationDomain::new` does
# (reference: uzkge/src/poly_commit/field_polynomial.rs:554-557).
FR_GENERATOR = 5
FR_TWO_ADICITY = 28
# 5^((r-1) / 2^28) mod r
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R_MOD - 1) >> FR_TWO_ADICITY, R_MOD)

# BN254 curve parameter x: r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
BN_X = 4965661367192848881
# Optimal-ate Miller loop count 6x+2
ATE_LOOP_COUNT = 6 * BN_X + 2

# ---------------------------------------------------------------------------
# G1 / G2 generators (standard alt_bn128 values, as in ark-bn254)
# ---------------------------------------------------------------------------

G1_GENERATOR = (1, 2)

# G2 generator coordinates in Fq2 = Fq[u]/(u^2+1), represented (c0, c1).
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# ---------------------------------------------------------------------------
# BabyJubjub (twisted Edwards curve over Fq of BN254's Fr... careful:
# BabyJubjub's base field is BN254's *scalar* field Fr, so its coordinates are
# Fr elements, which is what makes it SNARK-friendly here.)
#
#   a*x^2 + y^2 = 1 + d*x^2*y^2   over Fr
#
# ark-ed-on-bn254 uses the "scaled" form with a = 1.  The exact values below
# are recovered/validated from the reference's preprocessed generator tables
# (uzkge/src/shuffle/babyjubjub.rs:24+) in tests/test_curve.py.
# ---------------------------------------------------------------------------

# ark-ed-on-bn254: COEFF_A = 1, COEFF_D = 168696/168700 mod r
EDWARDS_A = 1
EDWARDS_D = (168696 * pow(168700, R_MOD - 2, R_MOD)) % R_MOD

# Prime order of the BabyJubjub subgroup (cofactor 8)
BJJ_ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041

# ark-ed-on-bn254 generator of the prime-order subgroup.
# (Validated against the reference's preprocessed table in tests.)
BJJ_GENERATOR = (
    19698561148652590122159747500897617769866003486955115824547446575314762165298,
    19298250018296453272277890825869354524455968081175474282777126169995084727839,
)
