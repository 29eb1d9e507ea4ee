"""Renderers: counterparts of neuralradiancecaching_tpu.render."""
