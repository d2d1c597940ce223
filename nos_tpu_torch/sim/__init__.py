"""The in-process cluster's stand-ins: the stub API server
(``apiserver.py``) and the sim kubelet (``kubelet.py``)."""
