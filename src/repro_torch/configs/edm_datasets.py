"""EDM dataset configurations: the paper's three zebrafish recordings
(Table I), as shapes only -- (series length L, active neurons N) and the
EDM configuration they run under.  Field for field those of the JAX
package's ``configs/edm_datasets.py``.  No recording ships with the
repository; the dry run (``launch/edm_dryrun.py``) makes random series of
these shapes."""
import dataclasses

from repro_torch.core.types import EDMConfig


@dataclasses.dataclass(frozen=True)
class EDMDatasetConfig:
    name: str
    n_time_steps: int  # L
    n_time_series: int  # N (active neurons)
    edm: EDMConfig = EDMConfig()


FISH1_NORMO = EDMDatasetConfig("Fish1_Normo", 1450, 53053)
SUBJECT6 = EDMDatasetConfig("Subject6", 3780, 92538)
SUBJECT11 = EDMDatasetConfig("Subject11", 8528, 101729)

DATASETS = {d.name.lower(): d for d in (FISH1_NORMO, SUBJECT6, SUBJECT11)}
