from .missing_data import mcar, mar, mnar, percentage_missing_values
from .toy_data import trendy_sine, state_space

__all__ = ["mcar", "mar", "mnar", "percentage_missing_values",
           "trendy_sine", "state_space"]
