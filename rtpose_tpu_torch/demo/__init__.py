"""Front-ends of the port: the picture and video demos, the HTTP pose
service with its micro-batcher, and the pipeline construction the CLIs
share (``picture_demo.build_pipeline`` / ``add_common_args``)."""
