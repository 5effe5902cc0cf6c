"""The port's CLI tools (``python -m nnet_asr_torch.tools.<name>``)."""


def not_ported(option: str, item: str) -> NotImplementedError:
    """The error an option of the JAX tool raises until the port carries it."""
    return NotImplementedError(
        f"{option} is not ported to nnet_asr_torch yet (ROADMAP.md {item})")
