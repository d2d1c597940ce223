"""The node agents: counterparts of ``nos_tpu/controllers/tpuagent`` (the
MIG agent, ``migagent``) and ``nos_tpu/controllers/sharingagent`` (the
MPS agent, ``mpsagent``)."""
