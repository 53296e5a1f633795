"""ChaCha20 RNG compatible with `rand_chacha::ChaCha20Rng`, plus the arkworks
field/element samplers built on it.

The reference derives deterministic artifacts from `ChaChaRng::from_seed`
(e.g. the quadratic non-residues k_i in the indexer use seed [0u8; 32],
uzkge/src/plonk/indexer.rs:258), so bit-exact vk regeneration requires an
identical word stream and rejection-sampling order.
"""

_M32 = 0xFFFFFFFF


def _rotl32(v, n):
    return ((v << n) | (v >> (32 - n))) & _M32


def _quarter(state, a, b, c, d):
    state[a] = (state[a] + state[b]) & _M32
    state[d] = _rotl32(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _M32
    state[b] = _rotl32(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _M32
    state[d] = _rotl32(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _M32
    state[b] = _rotl32(state[b] ^ state[c], 7)


class ChaCha20Rng:
    """rand_chacha's ChaCha20Rng: 64-byte blocks, block counter starts at 0,
    stream id 0; `next_u32` consumes the 16 output words of each block in
    order; `next_u64` = lo_word | hi_word << 32."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i * 4 : (i + 1) * 4], "little") for i in range(8)]
        self.counter = 0
        self.buf = []

    def _refill(self):
        const = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
        ctr = [self.counter & _M32, (self.counter >> 32) & _M32, 0, 0]
        init = const + self.key + ctr
        x = list(init)
        for _ in range(10):  # 20 rounds = 10 double-rounds
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        self.buf = [(a + b) & _M32 for a, b in zip(x, init)]
        self.counter += 1

    def next_u32(self) -> int:
        if not self.buf:
            self._refill()
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    # --- arkworks samplers -------------------------------------------------

    def ark_fr(self, modulus: int, n_limbs: int = 4) -> int:
        """ark-ff `Fp::rand`: sample N u64 limbs (LE order), mask the bits
        above MODULUS_BIT_SIZE in the top limb, reject if >= modulus.  The
        accepted BigInt is the *Montgomery residue*, so the field value is
        raw * R^-1 mod p with R = 2^(64*N)."""
        bit_size = modulus.bit_length()
        shave = 64 * n_limbs - bit_size
        mask = (1 << (64 - shave)) - 1
        r_inv = pow(1 << (64 * n_limbs), modulus - 2, modulus)
        while True:
            limbs = [self.next_u64() for _ in range(n_limbs)]
            limbs[-1] &= mask
            v = 0
            for i, l in enumerate(limbs):
                v |= l << (64 * i)
            if v < modulus:
                return v * r_inv % modulus


def choose_ks(modulus: int, n_wires_per_gate: int = 5, seed: bytes = b"\x00" * 32):
    """Reference `choose_ks` (uzkge/src/plonk/indexer.rs:211-235): k[0] = 1 and
    n_wires_per_gate - 1 distinct nonzero quadratic non-residues drawn from
    ChaCha20(seed)."""
    rng = ChaCha20Rng(seed)
    k = [1]
    exp = (modulus - 1) >> 1
    while len(k) < n_wires_per_gate:
        ki = rng.ark_fr(modulus)
        if ki == 0:
            continue
        if ki not in k and pow(ki, exp, modulus) != 1:
            k.append(ki)
    return k
