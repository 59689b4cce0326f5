"""Plain PyTorch reference of what the benchmark's cells run: full RoMa and
Tiny RoMa v1 from host images to dense warps, the balanced sampling, and
full RoMa's training step (train-mode forward, robust loss, autograd,
clip and AdamW).

Float32 with TF32 off. It imports nothing of the measured program and takes
nothing the program made: the resize matrices, the coordinate grids and the
anchors are worked out again here from the inputs and the weights.
`Precision("float8")` is the control: the same arithmetic with the operands
of every product the program runs in bfloat16, and the KDE's coordinates,
rounded to float8 e4m3 (in a training step, their gradients too). `Precision("bfloat16")` rounds those operands to
bfloat16: the yardstick of how far a sound bfloat16 program departs from
float32 on the same inputs.
"""
