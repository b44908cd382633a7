"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): what a roofline share is read against."""

H100 = {
    'f32_flops': 67e12,        # float32 outside the tensor cores
    'hbm_bytes_s': 3.35e12,
}
