from .loaders import (SceneLayout, SceneFolderSource, Co3dSource,  # noqa: F401
                      make_source, list_datasets)
from .multiview import (MultiViewDataset, CatDataset, MulDataset,  # noqa: F401
                        sample_view_offsets, make_batch_iter)
from .synthscene import generate_multiview_scenes  # noqa: F401
