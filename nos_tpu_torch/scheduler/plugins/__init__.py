"""The scheduler's nos plugins: counterpart of ``nos_tpu/scheduler/plugins``
(``capacity``; gangs, reservation and topology wait for their slice)."""
