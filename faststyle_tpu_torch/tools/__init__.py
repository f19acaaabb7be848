"""Tools of the port: the distillation trainer and its training corpus."""
