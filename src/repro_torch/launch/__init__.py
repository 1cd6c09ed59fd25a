"""Launch tools; mirrors `repro.launch`: the assigned shapes, input specs
and real batches (`shapes`), the device meshes (`mesh`), the roofline on
H100 constants (`roofline`), the collective inventory (`hlo`) and the
multi-pod dry-run (`dryrun`)."""
