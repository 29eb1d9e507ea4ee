"""Scene state: counterparts of neuralradiancecaching_tpu.scene."""
