"""Multi-device engines (port of ``qml_cutensornet_tpu/parallel``): the
process group and meshes (``mesh``), the Gram ring with mirror routing,
checkpoint and resume (``gram``), the site-sharded brick engine and its
relay (``sharded_mps``), and the multi-device dry run (``dryrun``). One
process per device, on ``torch.distributed``."""
