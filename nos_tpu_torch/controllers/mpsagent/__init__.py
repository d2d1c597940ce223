"""The MPS node agent: counterpart of ``nos_tpu/controllers/sharingagent``.
It only reports: the MPS device plugin actuates through its config map
(``partitioning/mps.py``, ``device/sharing.py``)."""
from nos_tpu_torch.controllers.mpsagent.reporter import MpsReporter

__all__ = ["MpsReporter"]
