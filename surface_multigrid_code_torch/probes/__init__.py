"""The port's counterparts of the Pallas probes of ``benchmarks/probes/``.

Each probe answers on the H100 the question its TPU probe asked, with the
hand-written kernels it needs, each beside its plain PyTorch version. No
probe runs on a path of the port; each is a measurement that prints one
JSON line:

- ``psd_precision``: K4's Newton-Schulz sign-apply at f32 (K4) and with
  its products on tensor cores (``ns_sign_apply_tc``, TF32 and 3xTF32),
  and on truncated schedules: least eigenvalue, distance to the f64
  eigen-projection, time (``probe_psd_precision.py``);
- ``psd_stages``: K4 by stage, from its loads and stores alone
  (``ns_sign_copy``) to the full schedule (``probe_psd_stages.py``);
- ``bf16_values``: K1 with bfloat16 values (``spmv_bf16_values``;
  ``probe_bf16_chain.py``'s question without the select chain);
- ``staged_spmv``: K1 with the x window staged in shared memory by
  ``cp.async``, double-buffered (``spmv_staged``; ``probe_dbuf.py``);
- ``band_spmv``: SpMV as a dense band times an x window on tensor cores
  (``band_spmv_tc``; ``probe_mxu_band.py``).

Run one: ``python -m surface_multigrid_code_torch.probes.NAME [--device
cpu] [...]``. On the CPU the wrappers run their plain versions and no
time is taken. ``chip_smoke.py`` runs all five on the card (phases 20
and 21).
"""
