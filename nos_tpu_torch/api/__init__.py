"""The port's API types: counterpart of ``nos_tpu/api`` (``v1alpha1``)."""
