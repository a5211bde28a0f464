"""Dataset conformance (the port's own copy of mine_tpu/data/conformance/):
"a loader works" as a checkable contract.

  * `contract.py`: the declarative LoaderContract per dataset family plus
    the shipped-config -> family table.
  * `fixtures.py`: one deterministic on-disk fixture writer per family, in
    the family's real wire format, all rendering the analytic two-plane
    scene (data/synthetic.py), so every loader runs with nothing
    downloaded.
  * `runner.py`: `check_contract` (batch/geometry/host-slice checks) and
    `check_loader` (the config through the port's train, evaluate and
    serving CLIs against its fixture), one JSON verdict per config;
    `python -m mine_tpu_torch.data.conformance` runs the matrix.
"""

from mine_tpu_torch.data.conformance.contract import (
    CONFIG_FAMILIES,
    CONTRACTS,
    ZOO_BUCKETS,
    LoaderContract,
    contract_for_config,
)
from mine_tpu_torch.data.conformance.fixtures import write_fixture
from mine_tpu_torch.data.conformance.runner import check_contract, check_loader
