"""The port's quality harnesses (counterparts of the JAX package's tools/ of
the same file names): train the analytic scene to quality and score novel
views against its analytic renderer (convergence_run), the ceiling of an MPI
that copies the source (oracle_mpi_ceiling), quality on disoccluded pixels
(disocclusion_analysis) and quality through the product CLIs alone
(e2e_quality_run). Each runs as `python -m mine_tpu_torch.tools.<name>`, on
the CUDA device unless `--device cpu` is given, and ends in one JSON verdict
line (utils/verdict.py)."""
