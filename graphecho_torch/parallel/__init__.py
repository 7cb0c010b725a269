from graphecho_torch.parallel.video_infer import make_video_infer  # noqa: F401
