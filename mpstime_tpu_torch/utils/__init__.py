from .preprocessing import (TransformNorms, transform_train_data,
                            transform_test_data, transform_data,
                            invert_test_transform)

__all__ = [
    "TransformNorms", "transform_train_data", "transform_test_data",
    "transform_data", "invert_test_transform",
]
