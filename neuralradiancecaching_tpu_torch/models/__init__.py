"""The radiance cache model: counterpart of neuralradiancecaching_tpu.models."""
