"""The port's CLI tools (``python -m nnet_asr_torch.tools.<name>``)."""
