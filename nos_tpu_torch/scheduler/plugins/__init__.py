"""The scheduler's nos plugins: counterpart of ``nos_tpu/scheduler/plugins``
(``capacity``, ``gang``, ``reservation``, ``topology``)."""
