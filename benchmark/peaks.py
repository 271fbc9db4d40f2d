"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W): memory bytes/s and operations/s by arithmetic."""

BYTES = 3.35e12
F32 = 67e12  # float32 outside the tensor cores
TF32 = 495e12
BF16 = 989.4e12  # bf16 products, f32 sums, on the tensor cores

# the peak a model's operations are held to, by the dtype they run in (float32
# runs with TF32 off)
BY_DTYPE = {"bfloat16": BF16, "float32": F32}
