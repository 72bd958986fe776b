"""Layers, subnets and the WaveNet stack as torch.nn.Modules."""
