from .loaders import (SceneLayout, SceneFolderSource, Co3dSource,  # noqa: F401
                      make_source, list_datasets)
from .multiview import (MultiViewDataset, CatDataset, MulDataset,  # noqa: F401
                        sample_view_offsets, make_batch_iter)
from .synthscene import generate_multiview_scenes  # noqa: F401
from .rgbd import (get_dataset, ReplicaDataset, ScanNetDataset,  # noqa: F401
                   TUMDataset)
from .synth_replica import write_replica_sequence  # noqa: F401
from .pairs import (homography_pair, reprojection_pair,  # noqa: F401
                    PairDataset, make_pair_iter)
