"""The plain reference of the Wan family's chain-of-frames edit, in float32
with TF32 off (another family adds its own modules here).

Written from the published Wan2.1 model code (the umT5 encoder, the DiT with
CoF repeat-RoPE and RIFLEx, the causal video VAE, Flow-UniPC) on the
published checkpoint layouts that `cofbench.families.wan_layouts`
enumerates. Weights arrive as the benchmark drew them (bf16) and are
widened to float32 where they are used, one layer at a time, so that the
14B fits beside nothing else. LoRA files are merged again here, in
float32. Nothing of the program under test is imported.
"""
