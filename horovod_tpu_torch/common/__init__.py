"""The port's Horovod runtime: basics, process sets, the controller,
the background cycle and the data plane on ``torch.distributed``."""
