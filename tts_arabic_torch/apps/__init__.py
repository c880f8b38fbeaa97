"""Command-line entry points of the port (`python -m
tts_arabic_torch.apps.<name>`)."""
