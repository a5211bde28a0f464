"""The port's command-line tools (counterparts of the JAX package's tools/ of
the same file names). The quality harnesses train the analytic scene to
quality and score novel views against its analytic renderer
(convergence_run), the ceiling of an MPI that copies the source
(oracle_mpi_ceiling), quality on disoccluded pixels (disocclusion_analysis)
and quality through the product CLIs alone (e2e_quality_run). The operator's
resilience CLIs run the fault drills end to end (chaos_drill), launch a
multi-process training job on one machine (multihost_harness) and gate on the
perf ledger (perf_ledger). Each runs as `python -m mine_tpu_torch.tools.<name>`,
on the CUDA device unless `--device cpu` is given (perf_ledger needs no
device), and ends in one JSON verdict line (utils/verdict.py)."""
