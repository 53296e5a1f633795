"""Host tools of the port, each runnable with `python -m`:

    python -m uzkge_tpu_torch.tools.gen_params_cli {cut-srs,gen-vk-common,all} ...
    python -m uzkge_tpu_torch.tools.gen_solidity_vk <n_cards> <out_dir> [--device D]

Counterparts of the JAX package's `tools/gen_params_cli.py` and
`tools/gen_solidity_vk.py`, built on this package's serializer and
gen_params.
"""
