"""The benchmark of the PyTorch and CUDA port (`tts_arabic_torch`); see
`run.py`."""
