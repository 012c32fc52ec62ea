"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
full 700 W power limit).  A card set below that limit runs slower under
load; the harness reads ``power.limit`` and reports it beside the shares."""

HBM_BYTES_PER_S = 3.35e12          # HBM3
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
MEMORY_BYTES = 80e9
