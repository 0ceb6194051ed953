"""Front-ends of the port.  So far only what the eval CLI needs:
``picture_demo.build_pipeline`` and ``add_common_args``; the demos
themselves wait for ROADMAP.md queue 1 item 4."""
