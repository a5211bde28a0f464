"""Training data (counterpart of mine_tpu/data): the dataset registry
(registry.py, the one name -> builder table over the synthetic scene and the
LLFF/NOCS, Objectron, RealEstate10K, KITTI, DTU and Flowers loaders), the
prefetch pipeline (pipeline.py) and the conformance contract and fixtures
(conformance/)."""
