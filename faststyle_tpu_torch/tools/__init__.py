"""Tools of the port: the distillation trainer and its training corpus, a
random-init VGG16, the TF1 checkpoint export and the fused content tower's
measurement."""
