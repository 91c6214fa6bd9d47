"""H100 probes: the counterparts of the TPU probes under ``benchmarks/``.

Each module is an entry point, ``python -m krasis_tpu_torch.probes.<name>``,
that times its kernels on the card (``--device cpu --small`` runs the plain
versions at tiny shapes) and prints the keys its TPU original prints:

* ``probe_int4_mxu`` — ``benchmarks/probe_int4_mxu.py`` (P4-P8);
* ``probe_w4a8`` — ``benchmarks/probe_w4a8.py`` (P1);
* ``probe_unpack_variants`` — ``benchmarks/probe_unpack_variants.py`` (P2);
* ``probe_gmm_terms`` — ``benchmarks/probe_gmm_terms.py`` (P3).

Results go to ``build/probes/<name>.json`` (``build/`` is not tracked).
"""
