from blobctrl_torch.pipeline.blobnet_pipeline import (  # noqa: F401
    BlobNetPipeline, PipelineOutput, blobnet_keep_schedule)
