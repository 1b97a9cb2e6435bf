"""The plain reference that decides ``correct``: plain PyTorch in float32
(TF32 off), layer by layer, importing nothing of the program. It takes the
benchmark's weights and inputs and works out again everything the program
derives from them: the 4-bit KV codes, the 8-bit moment codes."""
