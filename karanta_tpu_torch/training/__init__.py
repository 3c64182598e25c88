"""VLM fine-tuning: data, train step, optimizers, LoRA, checkpoints, CLI."""
