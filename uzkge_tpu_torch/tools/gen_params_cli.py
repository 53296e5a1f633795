"""gen-params CLI: parity with the reference's `gen-params` binary
(uzkge/src/gen_params/setup.rs:13-95).  Counterpart of the JAX package's
`tools/gen_params_cli.py`, on this package's serializer.

Subcommands:
  cut-srs <srs.bin> <out-dir>    Compact a full SRS (unchecked codec) into
                                 the srs-padding layout: powers 0..2050 plus
                                 the three t-split blinding powers at each of
                                 4096/8192/16384 (2060 G1 points total).
                                 Idempotent on an already-cut SRS.
  gen-vk-common <out-dir>        Emit vk-common.bin (bincode of the
                                 verifier-only KZG scheme: g1[0] + g2[0..2])
                                 from the embedded srs-padding.bin.
  all <srs.bin> <out-dir>        Both, vk-common.bin from the cut SRS.

Usage:  python -m uzkge_tpu_torch.tools.gen_params_cli cut-srs path/to/srs.bin out/
"""

import os
import sys

from ..gen_params import _read
from ..utils import serialize as ser


def cut_srs(srs_bytes: bytes) -> bytes:
    g1, g2 = ser.load_srs_unchecked(srs_bytes)
    if len(g1) == 2060:
        print("Already complete")
        return srs_bytes
    if len(g1) < 16387:
        raise ValueError(f"full SRS must have >= 16387 G1 powers, got {len(g1)}")
    new_g1 = (
        g1[0:2051] + g1[4096:4099] + g1[8192:8195] + g1[16384:16387]
    )
    return ser.srs_to_unchecked_bytes(new_g1, g2)


def gen_vk_common(srs_padding_bytes: bytes) -> bytes:
    g1, g2 = ser.load_srs_unchecked(srs_padding_bytes)
    assert len(g1) == 2060, "run cut-srs first"
    return ser.vk_common_to_bytes([g1[0]], [g2[0], g2[1]])


def _save(data: bytes, directory: str, name: str):
    path = os.path.join(directory, name)
    with open(path, "wb") as f:
        f.write(data)
    print(f"wrote {path} ({len(data)} bytes)")


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    if not args:
        print(__doc__)
        return 1
    cmd = args[0]
    if cmd == "cut-srs":
        srs, outdir = args[1], args[2]
        with open(srs, "rb") as f:
            _save(cut_srs(f.read()), outdir, "srs-padding.bin")
    elif cmd == "gen-vk-common":
        outdir = args[1]
        _save(gen_vk_common(_read("srs-padding.bin")), outdir, "vk-common.bin")
    elif cmd == "all":
        srs, outdir = args[1], args[2]
        with open(srs, "rb") as f:
            padded = cut_srs(f.read())
        _save(padded, outdir, "srs-padding.bin")
        _save(gen_vk_common(padded), outdir, "vk-common.bin")
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
