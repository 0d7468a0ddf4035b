"""Command-line tools of the port (``python -m imgcomp_cvpr_tpu_torch.tools.<name>``)."""
