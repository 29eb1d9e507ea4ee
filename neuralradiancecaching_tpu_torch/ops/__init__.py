"""Device kernels and tensor ops: counterparts of neuralradiancecaching_tpu.ops."""
