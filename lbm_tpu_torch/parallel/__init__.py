"""Multi-device paths of the port on torch.distributed (the counterpart of
`lbm_tpu.parallel`)."""
