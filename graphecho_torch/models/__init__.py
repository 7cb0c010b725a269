"""nn.Modules of the port: backbones, FPN, graph-matching head, discriminator."""
