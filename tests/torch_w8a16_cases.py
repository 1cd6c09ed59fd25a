"""Shapes shared by the W8A16 kernel's CPU and card tests."""

# (K, N) of every int8 matmul weight of the configured archs
# (`quant.quantize_tree` of each `configs/` arch at full size; the CPU
# test checks the list against the configs)
INT8_MATMUL_SHAPES = [
    (960, 320), (960, 960), (960, 2560), (2048, 2048), (2048, 7168),
    (2048, 8192), (2560, 960), (2560, 10576), (3072, 3072), (3072, 4096),
    (3072, 8192), (3072, 24576), (3584, 3584), (3584, 14336),
    (3584, 14576), (4096, 1024), (4096, 3072), (4096, 4096), (4096, 6400),
    (5120, 2560), (6400, 4096), (7168, 1024), (7168, 2048), (7168, 3584),
    (7168, 7168), (7168, 8192), (7168, 19200), (8192, 2048), (8192, 3072),
    (8192, 7168), (12288, 1024), (12288, 12288), (12288, 28672),
    (14336, 3584), (19200, 7168), (24576, 3072), (28672, 12288),
]

# rows a matrix the card tests run each shape at: one, serving's experts
# (5), one 8-row tile (16) and one row past it, the projections (32), and
# the kernel's limit
ROWS = [1, 5, 16, 17, 32, 64]

# Phi-3.5-MoE's decode step at serve-chat's 32 slots: the experts at
# C = int(1.25 * 32 * 2 / 16) = 5 rows each, the projections at 32 rows;
# (E or None, M, K, N)
SERVE_CHAT = {
    "experts up": (16, 5, 4096, 6400),
    "experts down": (16, 5, 6400, 4096),
    "wq, wo": (None, 32, 4096, 4096),
    "wk, wv": (None, 32, 4096, 1024),
}
