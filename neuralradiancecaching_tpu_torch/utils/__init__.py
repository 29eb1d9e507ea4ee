"""Utilities: counterparts of neuralradiancecaching_tpu.utils."""
