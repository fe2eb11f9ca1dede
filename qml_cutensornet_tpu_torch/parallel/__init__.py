"""Multi-device Gram build (port of ``qml_cutensornet_tpu/parallel``): the
process group and mesh (``mesh``), the Gram ring with mirror routing,
checkpoint and resume (``gram``), and the multi-device dry run
(``dryrun``). One process per device, on ``torch.distributed``."""
