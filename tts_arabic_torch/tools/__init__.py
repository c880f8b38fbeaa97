"""Measurement scripts for the port's kernels, run on the card
(`python -m tts_arabic_torch.tools.<name>`)."""
