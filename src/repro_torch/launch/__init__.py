"""Launch helpers; mirrors `repro.launch`: real input batches (`shapes`)
and the device meshes (`mesh`)."""
