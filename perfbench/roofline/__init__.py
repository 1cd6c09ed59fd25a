"""Operations and bytes of each kernel call and model step, and the
chip's published peaks, from shapes alone."""
