"""
Observed counts from a data-release CSV into one container (counterpart of
``pisa_tpu/stages/data/csv_data_hist.py``; reference
``pisa/stages/data/csv_data_hist.py``). Each row is a bin: its count at the
bin centre's reco_energy/reco_coszen/pid. The counts become 'weights', which
``utils.hist`` puts on the output binning. The file is read with bz2 and
numpy (``utils.fileio.read_csv``).
"""

from __future__ import annotations

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.fileio import read_csv
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["csv_data_hist", "init_test"]


class csv_data_hist(Stage):  # noqa: N801
    """Parameters: events_file (csv path). Has no apply step."""

    def __init__(self, events_file, **std_kwargs):
        self.events_file = find_resource(events_file)
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        events = read_csv(self.events_file)
        container = Container("total", representation="events",
                              device=self.data.device)
        for key, col in (("weights", "count"), ("reco_energy", "reco_energy"),
                         ("reco_coszen", "reco_coszen"), ("pid", "pid")):
            container[key] = events[col].astype(FTYPE)
        self.data.add_container(container)


def init_test(**param_kwargs):
    """Instantiation example."""
    return csv_data_hist(
        events_file="events/IceCube_3y_oscillations/data.csv.bz2"
    )
