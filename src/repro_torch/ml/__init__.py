"""Machine learning as a first-class citizen (paper §4).

SQL query results become TableRDDs — or stay lazy as SharkFrames — and
feature extraction and iterative algorithms run over the same partitions, on
the same workers, under the same lineage graph: no data export, end-to-end
fault tolerance.  Every estimator's `fit()` accepts a SharkFrame directly
(`clf.fit(frame, feature_cols=[...], label_col="y")`), so the paper's
Listing-1 pipeline is one fluent chain.

Analytics are a first-class workload (DESIGN.md §15): feature partitions
stay encoded (`FeatureRDD`), each training iteration is a PDE-scheduled
map stage whose per-partition step decodes the blocks on the session's
device (the dict / bit-pack / RLE decode kernels on a GPU) and computes
the gradient or assignment there (the `train_grad` kernel on large
partitions), and the routes/timings land in the same ExecMetrics the SQL
executor uses.
"""

from .featurize import FeatureRDD, as_features_rdd, table_rdd_to_features
from .logreg import LogisticRegression
from .linreg import LinearRegression
from .kmeans import KMeans
from .trainer import IterativeTrainer

__all__ = ["FeatureRDD", "IterativeTrainer", "as_features_rdd",
           "table_rdd_to_features", "LogisticRegression",
           "LinearRegression", "KMeans"]
